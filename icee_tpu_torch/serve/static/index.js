// Full-client logic: no-build equivalent of Main.vue's component state
// machine (app/frontend/src/components/Main.vue:128-187).
//
// State mirror of the Vue data():
//   file/filename  — custom file input label (handleFileUpload, :153-156)
//   mode           — radio group, default 'factual'
//   status         — init -> loading -> done|error badge (:92-97)
//   result         — nic / nic_att / stylenet / stylenet_att / path_img,
//                    thumbnail starts as the inline SVG placeholder (:146)
// generate() POSTs multipart to /generate?mode= and alert()s the server's
// error body on failure exactly like the axios catch (:175-183).
(function () {
  "use strict";
  var PLACEHOLDER =
    "data:image/svg+xml;charset=UTF-8,%3Csvg%20width%3D%22286%22%20height" +
    "%3D%22180%22%20xmlns%3D%22http%3A%2F%2Fwww.w3.org%2F2000%2Fsvg%22%3E" +
    "%3Crect%20width%3D%22286%22%20height%3D%22180%22%20fill%3D%22%23777" +
    "%22%3E%3C%2Frect%3E%3Ctext%20x%3D%2298%22%20y%3D%2296%22%20fill%3D%22" +
    "%23fff%22%3EImage%20cap%3C%2Ftext%3E%3C%2Fsvg%3E";

  // Declarative state->DOM tables (Main.vue:92-97, :146-156).  These are
  // JSON literals on purpose: tests/test_frontend_state.py parses them (no
  // JS engine exists offline) and fails if a badge state or result row is
  // changed or dropped.  BADGES maps status -> [className, text]; the
  // "init" row is the fallthrough default.
  var BADGES = {
    "init": ["badge badge-pill badge-secondary", "-"],
    "loading": ["badge badge-pill badge-primary", "loading..."],
    "done": ["badge badge-pill badge-success", "done!"],
    "error": ["badge badge-pill badge-danger", "error"]
  };
  var RESULT_KEYS = ["nic", "nic_att", "stylenet", "stylenet_att"];

  var state = {
    file: null,
    filename: "Choose file",
    mode: "factual",
    status: "init",
    result: {
      nic: "-", nic_att: "-", stylenet: "-", stylenet_att: "-",
      path_img: PLACEHOLDER,
    },
  };

  var el = function (id) { return document.getElementById(id); };

  // render(): the Vue-reactivity analogue — DOM reflects `state`
  function render() {
    el("filename").textContent = state.filename;
    var badge = el("status");
    badge.dataset.state = state.status;
    var spec = BADGES[state.status] || BADGES["init"];
    badge.className = spec[0];
    badge.textContent = spec[1];
    RESULT_KEYS.forEach(function (k) {
      el(k).textContent = state.result[k] || "-";
    });
    el("thumb").src = state.result.path_img || PLACEHOLDER;
  }

  el("inputFile").addEventListener("change", function (ev) {
    state.file = ev.target.files[0] || null;
    state.filename = state.file ? state.file.name : "Choose file";
    render();
  });
  el("filename").addEventListener("click", function () {
    el("inputFile").click();
  });

  el("generate").addEventListener("click", function () {
    var checked = document.querySelector('input[name="mode"]:checked');
    state.mode = checked ? checked.value : "factual";
    var form = new FormData();
    if (state.file) form.append("file", state.file, state.file.name);
    state.status = "loading";
    render();
    fetch("/generate?mode=" + state.mode, { method: "POST", body: form })
      .then(function (resp) {
        if (!resp.ok) {
          return resp.text().then(function (t) { throw new Error(t); });
        }
        return resp.json();
      })
      .then(function (data) {
        state.status = "done";
        state.result = data;
        if (data.path_img && data.path_img !== "-") {
          state.result.path_img = data.path_img;
        } else {
          state.result.path_img = PLACEHOLDER;
        }
        render();
      })
      .catch(function (err) {
        state.status = "error";
        render();
        // Main.vue alert()s the server's error body (:175-183)
        window.alert(err.message);
      });
  });

  render();
})();
