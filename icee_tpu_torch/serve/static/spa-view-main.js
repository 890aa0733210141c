// Main view component: no-build equivalent of the routed Vue SPA's
// components/Main.vue (app/frontend/src/components/Main.vue:1-187).
//
// The component object mirrors a Vue SFC's shape: `name`, a `template`
// string (the same markup the simplified variant inlines in index.html),
// and a `mounted` hook.  The state machine itself is NOT duplicated:
// `mounted` loads index.js — the one implementation both frontend variants
// share (its status-badge and result-row tables are contract-tested in
// tests/test_frontend_state.py).
(function () {
  "use strict";
  window.ICEE = window.ICEE || {};

  var TEMPLATE = [
    '<div class="container">',
    '  <div class="jumbotron">',
    '    <h1 class="display-4">Image Captioning with Emotion</h1>',
    '    <p class="lead">',
    '      Generating image caption with emotion in bahasa — TPU-native',
    '      rebuild (icee_tpu) of the reference final-project app.',
    '    </p>',
    '    <hr class="my-4">',
    '    <p>icee_tpu serving demo (routed SPA variant)</p>',
    '    <a class="btn btn-secondary" href="#/" role="button">Github</a>',
    '  </div>',
    '  <div class="row">',
    '    <div class="col-8">',
    '      <div class="form-group">',
    '        <span class="form-label">Image Path</span>',
    '        <label class="custom-file-label" for="inputFile"',
    '               id="filename">Choose file</label>',
    '        <input type="file" id="inputFile" accept="image/*">',
    '        <button class="btn btn-secondary" type="button" id="generate">',
    '          Generate</button>',
    '      </div>',
    '      <fieldset class="form-group" style="border:0;padding:0">',
    '        <span class="form-label">Mode</span>',
    '        <span class="form-check-inline">',
    '          <label><input type="radio" name="mode" value="factual"',
    '                        checked> Factual</label></span>',
    '        <span class="form-check-inline">',
    '          <label><input type="radio" name="mode" value="happy">',
    '            Happy</label></span>',
    '        <span class="form-check-inline">',
    '          <label><input type="radio" name="mode" value="sad">',
    '            Sad</label></span>',
    '        <span class="form-check-inline">',
    '          <label><input type="radio" name="mode" value="angry">',
    '            Angry</label></span>',
    '      </fieldset>',
    '      <div class="form-group">',
    '        <span class="form-label">Status</span>',
    '        <span class="badge badge-pill badge-secondary" id="status"',
    '              data-state="init">-</span>',
    '      </div>',
    '    </div>',
    '    <div class="col-4">',
    '      <img class="img-thumbnail" id="thumb" alt="Card image cap">',
    '    </div>',
    '  </div>',
    '  <div class="row my-5">',
    '    <div class="col-12">',
    '      <ul class="list-group">',
    '        <li class="list-group-item"><span id="nic">-</span>',
    '          <span class="badge badge-primary">NIC</span></li>',
    '        <li class="list-group-item"><span id="nic_att">-</span>',
    '          <span class="badge badge-danger">NIC+Att</span></li>',
    '        <li class="list-group-item"><span id="stylenet">-</span>',
    '          <span class="badge badge-primary">StyleNet</span></li>',
    '        <li class="list-group-item"><span id="stylenet_att">-</span>',
    '          <span class="badge badge-danger">StyleNet+Att</span></li>',
    '      </ul>',
    '    </div>',
    '  </div>',
    '</div>',
  ].join("\n");

  window.ICEE.Main = {
    name: "Main",
    template: TEMPLATE,
    mounted: function () {
      // single shared state machine: index.js binds to the ids above
      if (window.ICEE._mainLoaded) { return; }
      window.ICEE._mainLoaded = true;
      var s = document.createElement("script");
      s.src = "index.js";
      document.body.appendChild(s);
    },
  };
})();
