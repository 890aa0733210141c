"""Caption serving engine (port of ``icee_tpu/serve/engine.py``): the
``nic``, ``nic_att``, ``stylenet`` and ``stylenet_att`` variants.

Every pipeline is built once at startup; a request runs image decode (host)
-> ONE ResNet-152 pass, whose feature map gives both the pooled features
(for the global variants' encoder heads) and the 14 x 14 spatial features
(for the attention variants, with no head) -> each loaded variant's beam
decode on the device, with no model IO (the reference unpickles whole
modules per request, ``app/backend/sample.py:52-97``).  Beam semantics are
the JAX engine's: for ``nic`` and ``stylenet`` the serving copy's, the image
feature as the step-1 input (``app/backend/model.py:414-417``); for the
attention variants the research beam, ``<start>`` embedded at step 1 and
the image entering through h0/c0 and the attention.

Weights are random (``smoke_mode``, seeded per variant as in the JAX
engine), passed in as ``params``, checkpoints that the port's trainers
wrote (``checkpoint/ckpt.py``), or reference torch checkpoints (``.pth`` /
``.tar`` / ``.ckpt``: state dicts or full-module pickles, read without the
reference's classes).  ``config.backbone_dtype`` ("float32" or
"bfloat16"; any other value raises) sets the ResNet's conv weights' dtype,
as in the JAX engine: bfloat16 conv operands with float32 sums and
result, BatchNorm in float32.  The JAX package's orbax checkpoints raise:
the port imports no JAX to read them.

The serial :meth:`CaptionEngine.caption` decodes its one image through
the whole-search kernels: StyleNet and NIC through one K2 launch each, the
attention variants through one K7 launch each (the ``"mega"`` path);
``path="fused-step"`` takes the Python beam over K1 or K6 instead, which
gives the same bits.  :class:`~icee_tpu_torch.serve.batching.BatchingEngine`
decodes each mode group with one K2 or K7 launch per variant.  All give
the same captions.  The JAX engine's serial path runs the XLA beam
(``icee_tpu/serve/engine.py:203-212``) and neither of its kernels, so the
port's choice of kernel departs from nothing in JAX.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from icee_tpu_torch.core.config import (MODES, AttentionDecoderConfig,
                                        DecoderConfig, EncoderConfig, mode_id)
from icee_tpu_torch.core.device import resolve_device
from icee_tpu_torch.decode.beam import BeamResult
from icee_tpu_torch.decode.fast import (attention_decode, factored_decode,
                                        nic_att_decode, nic_decode)
from icee_tpu_torch.serve.config import MODEL_VARIANTS, ServeConfig

ATT_VARIANTS = ("nic_att", "stylenet_att")  # decode spatial features
BEAM_K = 5  # beam width of the serving decode, as in the JAX engine
TORCH_CKPT = (".pth", ".tar", ".ckpt")


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


class CaptionEngine:
    def __init__(self, config: ServeConfig, smoke_mode: bool = False,
                 image_size: int = 224, dec_cfg: Optional[DecoderConfig] = None,
                 enc_cfg: Optional[EncoderConfig] = None, device="cuda",
                 params: Optional[dict] = None,
                 att_cfg: Optional[AttentionDecoderConfig] = None):
        """``smoke_mode``: random seeded weights for each variant with no
        checkpoints configured.  ``params``: ``{"backbone": tree,
        "stylenet": {"decoder", "head"}, "nic": {...}, "stylenet_att":
        {"decoder"}, "nic_att": {...}}`` in the JAX layout (e.g. from
        :mod:`icee_tpu_torch.bridge`), any variant may be left out; a
        variant's trees serve all four modes (the attention variants need
        no head).  A variant's configured checkpoints take precedence over
        its ``params``.  The ``*_cfg`` overrides are for tests and small
        deployments; the defaults are the flagship sizes."""
        from icee_tpu_torch.data.vocab import SPECIALS, Vocabulary, load_vocab
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
        self.att_cfg = att_cfg or AttentionDecoderConfig(
            vocab_size=len(self.vocab))
        self.enc_cfg = enc_cfg or EncoderConfig()
        params = params or {}
        conv_dtype = resnet.backbone_dtype(config.backbone_dtype)
        backbone = params.get("backbone")
        if backbone is None:
            backbone = resnet.load_resnet_params(config.resnet_weights)
        if conv_dtype != torch.float32:
            # BACKBONE_DTYPE=bfloat16: bf16 conv weights, float32 BatchNorm,
            # as the JAX engine's loader casts them (cli/common.py:187-188)
            backbone = resnet.cast_conv_weights(backbone, conv_dtype)
        # conv weights HWIO -> OIHW once, at load, for cuDNN
        self.backbone = resnet.Backbone(_to(backbone, self.device))
        self.models: Dict[str, Dict[str, Dict[str, dict]]] = {}
        for variant in MODEL_VARIANTS:
            modes = self._load_variant(variant, params.get(variant),
                                       smoke_mode)
            if modes:
                self.models[variant] = modes

    # -- model loading ----------------------------------------------------

    def _template(self, variant: str) -> Tuple[dict, dict]:
        """The variant's random seeded (decoder, head), as the JAX engine
        seeds them: ``crc32(variant)``."""
        from icee_tpu_torch.models import attention as att_mod
        from icee_tpu_torch.models import encoder as enc_mod
        from icee_tpu_torch.models import factored_lstm as fl
        from icee_tpu_torch.models import lstm as nic

        seed = zlib.crc32(variant.encode())
        init, cfg = {
            "stylenet": (fl.init_params, self.dec_cfg),
            "nic": (nic.init_params, self.dec_cfg),
            "stylenet_att": (att_mod.init_factored_att_params, self.att_cfg),
            "nic_att": (att_mod.init_rnn_att_params, self.att_cfg)}[variant]
        dec = init(_generator(seed % (2**31)), cfg, device=self.device)
        head = enc_mod.init_head_params(_generator(seed % 1000 + 1),
                                        self.enc_cfg, device=self.device)
        return dec, head

    def _load_variant(self, variant: str, given: Optional[dict],
                      smoke_mode: bool) -> Dict[str, Dict[str, dict]]:
        """One (decoder, head) pipeline per mode, like the reference's
        16-entry registry (``app/backend/config.py:13-38``); a checkpoint
        path shared by several modes is loaded once."""
        paths = self.config.checkpoint_paths.get(variant, {})
        if not any(paths.values()):
            if given is not None:
                pipeline = _to({"decoder": given["decoder"],
                                "head": given.get("head")}, self.device)
            elif smoke_mode:
                dec, head = self._template(variant)
                pipeline = {"decoder": dec, "head": head}
            else:
                return {}
            return {mode: pipeline for mode in MODES}
        template = self._template(variant)
        by_path, modes = {}, {}
        for mode in MODES:
            path = paths.get(mode)
            if path and os.path.exists(path):
                if path not in by_path:
                    by_path[path] = self._restore(variant, path, template[1])
                dec, head = by_path[path]
            elif smoke_mode:
                dec, head = template
            else:
                continue
            modes[mode] = {"decoder": dec, "head": head}
        return modes

    def _restore(self, variant: str, path: str,
                 head_template: dict) -> Tuple[dict, dict]:
        """A checkpoint -> (decoder, head) on the device.  A directory that
        the port's trainers wrote (``checkpoint/ckpt.py``) loads through
        ``load_params``; a reference torch checkpoint is a decoder state
        dict (the head is then the variant's template), or a full-module
        pickle ``{"decoder", "encoder", ...}`` loaded with the stub
        unpickler, so the reference's classes are not needed.  The
        attention variants' spatial encoder has no head to import (the
        JAX engine's ``_restore`` looks for one in every full pickle)."""
        from icee_tpu_torch.checkpoint import ckpt
        from icee_tpu_torch.checkpoint import torch_import as ti
        from icee_tpu_torch.checkpoint.torch_pickle import (load_torch_pickle,
                                                            module_state_dict)

        if ckpt.is_port_checkpoint(path):
            params = ckpt.load_params(path, self.device)
            head = params.get("head")
            return params["decoder"], (head_template if head is None
                                       else head)
        if not path.endswith(TORCH_CKPT):
            raise NotImplementedError(
                f"{path}: neither a checkpoint written by the port's "
                f"trainers (a directory holding {ckpt.CKPT_FILE}) nor a "
                f"reference torch checkpoint ({', '.join(TORCH_CKPT)}); the "
                "JAX package's orbax checkpoints are not read by the port, "
                "which imports no JAX: retrain with the port or export the "
                "reference's torch format")
        sd = load_torch_pickle(path)
        if isinstance(sd, dict) and "decoder" in sd:  # full ckpt pickle
            dec_sd = module_state_dict(sd["decoder"])
            enc_sd = module_state_dict(sd["encoder"])
        else:
            dec_sd, enc_sd = sd, None
        dec = {"stylenet": ti.import_factored_decoder_state_dict,
               "nic": ti.import_nic_decoder_state_dict,
               "stylenet_att": ti.import_factored_att_decoder_state_dict,
               "nic_att": ti.import_nic_att_decoder_state_dict}[variant](
                   dec_sd)
        head = head_template
        if enc_sd is not None and variant not in ATT_VARIANTS:
            head = _to(ti.import_encoder_head_state_dict(
                {k: v for k, v in enc_sd.items()
                 if not k.startswith("resnet.")}), self.device)
        return _to(dec, self.device), head

    # -- inference --------------------------------------------------------

    @torch.inference_mode()
    def _features(self, image_path: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """ONE ResNet-152 pass -> pooled (1, 2048) features, shared by the
        global variants' heads, and spatial (1, 196, 2048) features, shared
        by the attention variants: both derive from the same feature map
        (the JAX engine's review found a second backbone pass per request)."""
        from icee_tpu_torch.data.transforms import host_decode_resize, normalize

        img = host_decode_resize(image_path, self.image_size)
        x = normalize(torch.tensor(img, device=self.device)[None])
        return self.backbone.features(x)

    @torch.inference_mode()
    def head(self, pooled: torch.Tensor, mode: str,
             variant: str = "stylenet") -> torch.Tensor:
        """Pooled (1, 2048) features -> (1, E) step-1 feature of the
        variant's pipeline for ``mode``."""
        from icee_tpu_torch.models import encoder as enc_mod

        return enc_mod.encode_global_from_pooled(
            self.models[variant][mode]["head"], pooled)

    def features(self, pooled: torch.Tensor, spatial: torch.Tensor,
                 mode: str, variant: str) -> torch.Tensor:
        """The variant's decoder input from one backbone pass: the spatial
        features (attention variants) or the pooled features through the
        mode's encoder head, (1, E)."""
        if variant in ATT_VARIANTS:
            return spatial
        return self.head(pooled, mode, variant)

    def encode(self, image_path: str, mode: str,
               variant: str = "stylenet") -> torch.Tensor:
        """Image -> the variant's decoder input (one backbone pass, then the
        head or the spatial grid)."""
        return self.features(*self._features(image_path), mode, variant)

    @torch.inference_mode()
    def decode(self, feats: torch.Tensor, mode: str, path: str = "mega",
               variant: str = "stylenet") -> BeamResult:
        """Decoder inputs -> beam results for ``n`` images: (n, E) step-1
        features, or (n, P, FS) spatial features for the attention
        variants.  StyleNet and the attention variants decode via ``path``
        (``"mega"`` or ``"fused-step"``); NIC has the one path, K2 with the
        LSTM cell."""
        n = feats.shape[0]
        dec = self.models[variant][mode]["decoder"]
        if variant in ATT_VARIANTS:
            common = (n, BEAM_K, self.att_cfg.max_seq_length,
                      self.vocab.start, self.vocab.end)
            if variant == "nic_att":
                return nic_att_decode(path, dec, feats, *common)
            return attention_decode(path, dec, feats, mode_id(mode), *common)
        tiled = feats[:, None, :].expand(n, BEAM_K, feats.shape[1]).contiguous()
        common = (n, BEAM_K, self.dec_cfg.max_seq_length, self.vocab.start,
                  self.vocab.end)
        if variant == "nic":
            return nic_decode(dec, tiled, *common)
        return factored_decode(path, dec, tiled, mode_id(mode), *common)

    def _detok(self, tokens, length) -> str:
        """id seq -> caption: strip <start>/<end>, drop trailing <unk>
        (``app/backend/sample.py:82-96``)."""
        ids = np.asarray(tokens.cpu())[: int(length)]
        words = self.vocab.decode(ids)
        while words and words[-1] == "<unk>":
            words.pop()
        return " ".join(words)

    def caption(self, image_path: str, mode: str,
                path: str = "mega") -> Dict[str, str]:
        """Every variant's caption of one image (``run.py:42-57``), from one
        backbone pass; the stylenet and attention beams run ``path``
        (``"mega"``: one K2 or K7 launch; ``"fused-step"``: K1 or K6 per
        step), NIC one K2 launch."""
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode}")
        out = {variant: "-" for variant in MODEL_VARIANTS}
        loaded = [v for v in MODEL_VARIANTS
                  if mode in self.models.get(v, {})]
        if loaded:
            pooled, spatial = self._features(image_path)
            for variant in loaded:
                res = self.decode(self.features(pooled, spatial, mode,
                                                variant),
                                  mode, path, variant)
                out[variant] = self._detok(res.tokens[0], res.length[0])
        return out
