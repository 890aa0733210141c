// App entry: no-build equivalent of the routed Vue SPA's main.js
// (app/frontend/src/main.js:1-12 — construct the app with the router and
// mount it on #app; App.vue's whole template is `<router-view/>`, so the
// #app element IS the router-view slot here).
(function () {
  "use strict";
  window.ICEE.router.mount(document.getElementById("app"));
})();
