"""``python -m icee_tpu_torch.serve`` — run the caption demo server (port of
``icee_tpu/serve/__main__.py``).

Same contract as the reference's ``python app/backend/run.py`` (Flask dev
server, ``app/backend/run.py:63-65``): serves ``POST /generate?mode=`` +
``GET /images/<f>`` and the bundled frontend at ``/``, on the card unless
``--device cpu``.
"""
from icee_tpu_torch.serve.app import main

if __name__ == "__main__":
    main()
