"""SentiCap configuration (reference conf dict, ``mrnn.py:30-111`` with the
switch-training overrides from ``mrnn_switched.py:90-170`` /
``train_joint.py:328-372``); a copy of ``icee_tpu/senticap/config.py``."""

from __future__ import annotations

from typing import Any, Dict

# domain-adaptation (output mixing) modes, ``mrnn_switched.py``
DA_SUM = "da_sum"
DA_FIXED_ALPHA = "da_fixed_alpha"
DA_SIMILAR_PARAM = "da_similar_param"
DA_SIMILAR_PARAM_2 = "da_similar_param_2"
DA_SIMILAR_PARAM_3 = "da_similar_param_3"

RMSPROP = "rmsprop"
ADADELTA = "adadelta"


def senticap_conf(**overrides: Any) -> Dict[str, Any]:
    """Defaults mirroring ``mrnn.py:30-111``; switch training bumps
    emb/hidden to 512 and batch to 128 (``train_joint.py:328-340``)."""
    conf: Dict[str, Any] = {
        "GRAD_METHOD": RMSPROP,
        "learning_rate": 0.001,
        "decay": 0.999,
        "rho": 0.95,                 # adadelta
        "GRAD_CLIP_SIZE": 5.0,
        "L2_REG_CONST": 1e-8,
        "ATT_REG_CONST": 50.0,
        "LAMBDA_N": 0.25,
        "LAMBDA_GAM": 0.25,
        "MAX_SENTENCE_LEN": 20,
        "batch_size_val": 200,
        "emb_size": 256,
        "lstm_hidden_size": 256,
        "visual_size": 4096,
        "DROP_INPUT": True,
        "DROP_OUTPUT": True,
        "DROP_INPUT_FRACTION": 0.5,
        "DROP_OUTPUT_FRACTION": 0.5,
        "SEMI_FORCED": 1.0,          # 1 => fully teacher-forced
        "SOFTMAX_OUT": True,
        "BATCH_NORM": False,
        "JOINED_LOSS_FUNCTION": False,
        "DOMAIN_ADAPT": DA_SUM,
        "FIXED_ALPHA": 0.5,
        "SIMILAR_PARAM_REG": 1e-3,
        "MIN_WORD_FREQ": 5,
        # extension (no reference counterpart): chunked training loss, the
        # (B, T, V) distributions never materialize (ops/chunked_loss.py).
        # None = auto: on for CUDA tensors.  FUSED_SCAN (absent = None)
        # likewise routes the teacher-forced scan through K8.
        "CHUNKED_CE": None,
    }
    conf.update(overrides)
    return conf


# the switch-only trainable set (``train_joint.py:355-359``)
# ``wsenti`` is a DEAD parameter reproduced for checkpoint/trainable-set
# parity: the reference creates it (``mrnn_switched.py:574-580``) and lists
# it trainable (``train_joint.py:355-359``) but its only use is commented
# out (``mrnn_switched.py:699-700``); it receives zero gradient.
SWITCH_PARAMS = ("wemb_sw", "w_sw", "b_sw", "w_lstm_sw", "att_w", "att_b",
                 "wsenti", "wvm_sw", "bmv_sw")
