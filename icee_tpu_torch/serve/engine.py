"""Caption serving engine (port of ``icee_tpu/serve/engine.py``), StyleNet
variant.

Every pipeline is built once at startup; a request runs image decode (host)
-> ResNet-152 -> encoder head -> beam decode on the device, with no model IO
(the reference unpickles whole modules per request,
``app/backend/sample.py:52-97``).  Beam semantics are the serving copy's:
the image feature is the step-1 input (``app/backend/model.py:414-417``).

This slice serves the ``stylenet`` variant; ``nic``, ``nic_att`` and
``stylenet_att`` answer ``"-"``, as the JAX engine does for a variant it has
not loaded.  Weights are random (``smoke_mode``, seeded) or passed in as
``params``; loading checkpoints comes with a later slice.

The serial :meth:`CaptionEngine.caption` decodes through the ``"fused-step"``
path (kernel K1); :class:`~icee_tpu_torch.serve.batching.BatchingEngine`
decodes groups through ``"mega"`` (kernel K2).  Both give the same captions.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from icee_tpu_torch.core.config import (MODES, DecoderConfig, EncoderConfig,
                                        mode_id)
from icee_tpu_torch.core.device import resolve_device
from icee_tpu_torch.decode.beam import BeamResult
from icee_tpu_torch.decode.fast import factored_decode
from icee_tpu_torch.serve.config import MODEL_VARIANTS, ServeConfig

VARIANT = "stylenet"
BEAM_K = 5  # beam width of the serving decode, as in the JAX engine


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


class CaptionEngine:
    def __init__(self, config: ServeConfig, smoke_mode: bool = False,
                 image_size: int = 224, dec_cfg: Optional[DecoderConfig] = None,
                 enc_cfg: Optional[EncoderConfig] = None, device="cuda",
                 params: Optional[dict] = None):
        """``smoke_mode``: random seeded weights when no checkpoints are
        configured.  ``params``: ``{"backbone", "decoder", "head"}`` trees in
        the JAX layout (e.g. from :mod:`icee_tpu_torch.bridge`), used for all
        four modes.  The ``*_cfg`` overrides are for tests and small
        deployments; the defaults are the flagship sizes."""
        from icee_tpu_torch.data.vocab import SPECIALS, Vocabulary, load_vocab
        from icee_tpu_torch.models import encoder as enc_mod
        from icee_tpu_torch.models import factored_lstm as fl
        from icee_tpu_torch.models import resnet

        self.config = config
        self.device = resolve_device(device)
        self.image_size = image_size
        if config.vocab_path and os.path.exists(config.vocab_path):
            self.vocab = load_vocab(config.vocab_path)
        elif smoke_mode:
            self.vocab = Vocabulary()
            for s in SPECIALS:
                self.vocab.add_word(s)
            for w in ["sebuah", "gambar", "tanpa", "model"]:
                self.vocab.add_word(w)
        else:
            raise FileNotFoundError(f"vocab not found: {config.vocab_path}")

        self.dec_cfg = dec_cfg or DecoderConfig(vocab_size=len(self.vocab))
        self.enc_cfg = enc_cfg or EncoderConfig()
        if config.resnet_weights or any(
                config.checkpoint_paths.get(VARIANT, {}).values()):
            raise NotImplementedError(
                "loading checkpoints is not ported yet: serve with "
                "smoke_mode or pass params")

        self.models: Dict[str, Dict[str, dict]] = {}
        self.backbone = None
        if params is None and smoke_mode:
            seed = zlib.crc32(VARIANT.encode())
            params = {
                "backbone": resnet.init_params(_generator(0),
                                               device=self.device),
                "decoder": fl.init_params(_generator(seed % (2**31)),
                                          self.dec_cfg, device=self.device),
                "head": enc_mod.init_head_params(
                    _generator(seed % 1000 + 1), self.enc_cfg,
                    device=self.device),
            }
        if params is not None:
            # conv weights HWIO -> OIHW once, at load, for cuDNN
            self.backbone = resnet.Backbone(params["backbone"])
            pipeline = {"decoder": params["decoder"], "head": params["head"]}
            self.models[VARIANT] = {mode: pipeline for mode in MODES}

    # -- inference --------------------------------------------------------

    @torch.inference_mode()
    def _features(self, image_path: str) -> torch.Tensor:
        """One ResNet-152 pass -> pooled (1, 2048) features."""
        from icee_tpu_torch.data.transforms import host_decode_resize, normalize

        img = host_decode_resize(image_path, self.image_size)
        x = normalize(torch.tensor(img, device=self.device)[None])
        return self.backbone(x)

    @torch.inference_mode()
    def encode(self, image_path: str, mode: str) -> torch.Tensor:
        """Image -> (1, E) step-1 feature of the mode's pipeline."""
        from icee_tpu_torch.models import encoder as enc_mod

        head = self.models[VARIANT][mode]["head"]
        return enc_mod.encode_global_from_pooled(head,
                                                 self._features(image_path))

    @torch.inference_mode()
    def decode(self, feats: torch.Tensor, mode: str, path: str) -> BeamResult:
        """(n, E) features -> beam results for ``n`` images via ``path``."""
        n = feats.shape[0]
        tiled = feats[:, None, :].expand(n, BEAM_K, feats.shape[1]).contiguous()
        return factored_decode(
            path, self.models[VARIANT][mode]["decoder"], tiled, mode_id(mode),
            n, BEAM_K, self.dec_cfg.max_seq_length, self.vocab.start,
            self.vocab.end)

    def _detok(self, tokens, length) -> str:
        """id seq -> caption: strip <start>/<end>, drop trailing <unk>
        (``app/backend/sample.py:82-96``)."""
        ids = np.asarray(tokens.cpu())[: int(length)]
        words = self.vocab.decode(ids)
        while words and words[-1] == "<unk>":
            words.pop()
        return " ".join(words)

    def caption(self, image_path: str, mode: str) -> Dict[str, str]:
        """Every variant's caption of one image (``run.py:42-57``); the
        stylenet beam runs the fused-step path."""
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode}")
        out = {variant: "-" for variant in MODEL_VARIANTS}
        if mode in self.models.get(VARIANT, {}):
            res = self.decode(self.encode(image_path, mode), mode, "fused-step")
            out[VARIANT] = self._detok(res.tokens[0], res.length[0])
        return out
