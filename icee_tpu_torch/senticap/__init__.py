"""SentiCap (the mRNN captioner and its sentiment switch), ported from
``icee_tpu/senticap/``: the base model's and the switched model's training
and beam decode (``config``, ``io``, ``model``, ``switched``, ``solver``,
``train``, ``beam``), the sentiment lexicon and ANP scores
(``sentiment``), the test path's eval files and metrics (``eval_out``),
and the adversarial-style and encoder-decoder variants (``adversarial``,
``encode_decode``).  Their CLI is ``icee_tpu_torch.cli.senticap_train``.
The steps and the training loops take a data-parallel ``mesh``
(``train.py``)."""
