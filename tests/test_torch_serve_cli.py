"""``python -m icee_tpu_torch.serve`` as a process on the CPU: it starts with
``--device cpu --smoke`` (random weights at the flagship widths), serves
``GET /`` with the bytes of the JAX package's ``index.html``, the other
static files by name (404 for a name it does not hold), and answers
``POST /generate?mode=happy`` with a caption from every variant."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_STATIC = os.path.join(ROOT, "icee_tpu", "serve", "static")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    port = _free_port()
    env_file = tmp / "serve.env"
    env_file.write_text(f"BACKEND_HOST=127.0.0.1\n"
                        f"IMAGE_FOLDER={tmp / 'uploads'}\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("VOCAB_PATH", "RESNET_WEIGHTS", "BACKBONE_DTYPE",
                        "BATCH_WINDOW_MS") and not k.startswith(
                            "CHECKPOINT_PATH_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "icee_tpu_torch.serve", "--device", "cpu",
         "--smoke", "--env", str(env_file), "--port", str(port)],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                urllib.request.urlopen(url + "/index.js", timeout=5).read()
                break
            except (urllib.error.URLError, ConnectionError):
                if proc.poll() is not None or time.time() > deadline:
                    raise RuntimeError(f"the server did not start: "
                                       f"{proc.stdout.read()}")
                time.sleep(0.5)
        yield url
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_root_serves_the_jax_index_page(server):
    status, ctype, body = _get(server + "/")
    with open(os.path.join(JAX_STATIC, "index.html"), "rb") as f:
        assert body == f.read()
    assert status == 200 and ctype == "text/html"


@pytest.mark.parametrize("name", sorted(os.listdir(JAX_STATIC)))
def test_static_files_are_served_by_name(server, name):
    status, _, body = _get(f"{server}/{name}")
    with open(os.path.join(JAX_STATIC, name), "rb") as f:
        assert status == 200 and body == f.read()


def test_missing_file_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server + "/no-such-file.js")
    assert err.value.code == 404


def test_generate_answers_every_variant(server):
    with open(os.path.join(ROOT, "examples", "data", "img", "i2.jpg"),
              "rb") as f:
        data = f.read()
    b = "testboundary"
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"i2.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n"
            ).encode() + data + f"\r\n--{b}--\r\n".encode()
    req = urllib.request.Request(
        server + "/generate?mode=happy", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={b}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    assert set(out) == {"nic", "nic_att", "stylenet", "stylenet_att",
                        "path_img"}
    assert out["path_img"] == "/images/i2.jpg"
    assert all(isinstance(v, str) and v != "-" for v in out.values())
    status, _, img = _get(server + out["path_img"])
    assert status == 200 and img == data
