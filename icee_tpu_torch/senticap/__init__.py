"""SentiCap (the mRNN captioner and its sentiment switch), ported from
``icee_tpu/senticap/``: the base model's and the switched model's training
and beam decode (``config``, ``io``, ``model``, ``switched``, ``solver``,
``train``, ``beam``)."""
