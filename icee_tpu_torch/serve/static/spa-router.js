// Hash router: no-build equivalent of the routed Vue SPA's router shell
// (app/frontend/src/router.js:1-17 — vue-router with a single named route
// {path: '/', name: 'Main', component: Main}; the reference uses history
// mode behind a dev server, the no-build variant uses hash mode so it
// serves from the flat static handler without URL rewrites).
//
// ROUTES is a JSON literal on purpose: tests/test_frontend_spa.py parses
// it (no JS engine offline) and fails if the route table diverges from
// router.js's structure.  `component` is the name of a view object
// registered on window.ICEE by its spa-view-*.js file.
(function () {
  "use strict";
  window.ICEE = window.ICEE || {};

  var ROUTES = [
    {"path": "/", "name": "Main", "component": "Main"}
  ];

  function createRouter(routes) {
    var router = {
      mode: "hash",
      routes: routes,
      currentRoute: null,
      _el: null,
    };

    function resolve() {
      var path = (window.location.hash || "#/").slice(1) || "/";
      for (var i = 0; i < routes.length; i++) {
        if (routes[i].path === path) { return routes[i]; }
      }
      return null;
    }

    function render() {
      var route = resolve();
      if (!route) {
        // unknown path -> redirect to '/' (vue-router's default
        // behavior for the single-route table)
        window.location.hash = "#/";
        return;
      }
      router.currentRoute = route;
      var view = window.ICEE[route.component];
      router._el.innerHTML = view.template;
      if (view.mounted) { view.mounted(); }
    }

    router.mount = function (el) {
      router._el = el;                     // the <router-view/> slot
      window.addEventListener("hashchange", render);
      render();
      return router;
    };
    return router;
  }

  window.ICEE.router = createRouter(ROUTES);
})();
