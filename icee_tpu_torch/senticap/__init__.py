"""SentiCap (the mRNN captioner and its sentiment switch), ported from
``icee_tpu/senticap/``: so far the base model's training and beam decode
(``config``, ``io``, ``model``, ``solver``, ``train``, ``beam``)."""
