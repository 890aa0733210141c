"""Shared CLI plumbing: configs from flags, backbone weights, feature
providers (port of ``icee_tpu/cli/common.py``).

The flags are the JAX CLIs' (same names, same defaults), plus ``--device``
(default ``cuda``): every entry point runs on the card unless asked for the
CPU, and asking for CUDA where there is none raises
(:func:`icee_tpu_torch.core.device.resolve_device`).  JAX's
``ICEE_PLATFORM`` knob selects a JAX platform and has no counterpart here.

Feature sourcing (three ways, first available wins):

1. ``--feature_cache path.npz`` — precomputed ``{image_name: feature}``
   arrays (``cli/precompute_features.py`` writes them: encode each image
   once and reuse it every epoch),
2. ``--image_dir`` + optional ``--resnet_weights`` (torch ``.pth`` state
   dict or module pickle, or ``.npz``) — runs the port's ResNet-152 on the
   device,
3. random-but-deterministic per-image features (no weights available —
   offline smoke mode, clearly logged), the same arrays as the JAX CLIs'.
"""

from __future__ import annotations

import argparse
import os
import zlib
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from icee_tpu_torch.core.config import (AttentionDecoderConfig,
                                        DecoderConfig, TrainConfig)

def add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--embed_size", type=int, default=300)
    p.add_argument("--hidden_size", type=int, default=512,
                   help="the decoder's width; on the card the training "
                        "scans (K3, K4) take up to 2048, with batch sizes "
                        "up to 2048")
    p.add_argument("--factored_size", type=int, default=512)
    p.add_argument("--attention_size", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--max_seq_length", type=int, default=40)
    p.add_argument("--backbone_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="ResNet conv precision: bfloat16 conv operands with "
                        "float32 sums and results (BatchNorm stays float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu (the plain "
                        "PyTorch versions of the kernels)")


def add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", type=str, default="happy")
    p.add_argument("--num_epochs", type=int, default=120)
    p.add_argument("--caption_batch_size", type=int, default=64)
    p.add_argument("--language_batch_size", type=int, default=96)
    p.add_argument("--lr_caption", type=float, default=2e-4)
    p.add_argument("--lr_language", type=float, default=5e-4)
    p.add_argument("--grad_clip", type=float, default=0.5)
    p.add_argument("--log_step", type=int, default=50)
    p.add_argument("--log_step_emotion", type=int, default=5)
    p.add_argument("--log_path", type=str, default="out.log")
    p.add_argument("--metrics_path", type=str, default=None,
                   help="append-only JSONL metrics file "
                        "(utils/logging.MetricsLogger): one record per "
                        "epoch/track with loss/ppl/top-5/BLEU-4/LR")
    p.add_argument("--model_path", type=str, default="models/")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused_scan", choices=["auto", "on", "off"],
                   default="auto",
                   help="the training scan kernels (K3 ops/lstm_scan.py, "
                        "K4 ops/nic_scan.py, K5 ops/att_scan.py); auto = on "
                        "for a CUDA device")
    p.add_argument("--chunked_ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="chunked training CE (ops/chunked_loss.py, the "
                        "(B,T,V) logits never materialize); auto = on for "
                        "a CUDA device")
    p.add_argument("--progress_chunk", type=int, default=0,
                   help="with --device_resident, write a mid-epoch "
                        "progress record every N batches "
                        "(checkpoint/progress.py) so a killed run resumes "
                        "inside the epoch; 0 = off")


def add_data_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--vocab_path", type=str,
                   default="data/flickr8k_id/vocab.pkl")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--caption_path", type=str,
                   default="data/flickr8k_id/train.txt")
    p.add_argument("--val_caption_path", type=str,
                   default="data/flickr8k_id/val.txt")
    p.add_argument("--happy_path", type=str,
                   default="data/flickr8k_id/happy/train.txt")
    p.add_argument("--val_happy_path", type=str,
                   default="data/flickr8k_id/happy/val.txt")
    p.add_argument("--sad_path", type=str,
                   default="data/flickr8k_id/sad/train.txt")
    p.add_argument("--val_sad_path", type=str,
                   default="data/flickr8k_id/sad/val.txt")
    p.add_argument("--angry_path", type=str,
                   default="data/flickr8k_id/angry/train.txt")
    p.add_argument("--val_angry_path", type=str,
                   default="data/flickr8k_id/angry/val.txt")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--feature_cache", type=str, default=None,
                   help="npz of precomputed image features")
    p.add_argument("--resnet_weights", type=str, default=None,
                   help="torch .pth state_dict or .npz for ResNet-152")


def decoder_config(args, vocab_size: int, attention: bool = False):
    cls = AttentionDecoderConfig if attention else DecoderConfig
    return cls(
        vocab_size=vocab_size,
        embed_size=args.embed_size,
        hidden_size=args.hidden_size,
        factored_size=args.factored_size,
        num_layers=args.num_layers,
        dropout=args.dropout,
        max_seq_length=args.max_seq_length,
        **({"attention_size": args.attention_size} if attention else {}),
    )


def train_config(args) -> TrainConfig:
    return TrainConfig(
        mode=args.mode,
        num_epochs=args.num_epochs,
        caption_batch_size=args.caption_batch_size,
        language_batch_size=args.language_batch_size,
        lr_caption=args.lr_caption,
        lr_language=args.lr_language,
        grad_clip=args.grad_clip,
        log_step=args.log_step,
        log_step_emotion=args.log_step_emotion,
        max_caption_len=args.max_seq_length + 2,
        seed=args.seed,
        crop_size=args.crop_size,
        fused_scan={"auto": None, "on": True, "off": False}[
            getattr(args, "fused_scan", "auto")],
        chunked_ce={"auto": None, "on": True, "off": False}[
            getattr(args, "chunked_ce", "auto")],
        progress_chunk=getattr(args, "progress_chunk", 0),
    )


def device_of(args) -> torch.device:
    """The CLI's ``--device``, resolved (CUDA's absence raises)."""
    from icee_tpu_torch.core.device import resolve_indexed_device

    return resolve_indexed_device(getattr(args, "device", "cuda"))


def load_resnet_params(path: Optional[str], conv_dtype: str = "float32"):
    """Backbone weights (CPU, the JAX layout) from a torch ``.pth`` (a state
    dict or a pickled module) or an ``.npz`` of the state dict's names, or a
    random init from a ``torch.Generator`` seeded 0 (JAX draws its init
    with ``jax.random``, which torch cannot reproduce: hand both packages
    one npz to compare them).  ``conv_dtype="bfloat16"`` casts only the
    conv kernels."""
    from icee_tpu_torch.models import resnet

    params = resnet.load_resnet_params(path)
    if conv_dtype != "float32":
        params = resnet.cast_conv_weights(params,
                                          resnet.backbone_dtype(conv_dtype))
    return params


def tree_to(tree, device):
    """A tensor tree (dicts and lists) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def make_feature_provider(
    args, spatial: bool = False, grid: int = 14, augment: bool = False,
    resize_size: int = 336, seed: int = 0,
) -> Callable[[str], np.ndarray]:
    """image name -> encoder feature array (see module docstring).

    ``augment=True`` reproduces the reference TRAINING transform
    (Resize(336) -> RandomCrop(224) -> RandomHorizontalFlip,
    ``train_multitask.py:63-69``): the decoded 336px image is cached in a
    bounded LRU, the random crop and flip (a ``torch.Generator`` seeded
    ``seed`` on the device) and the backbone run on every call, so every
    epoch sees new crops.  ``augment=False`` is the eval transform
    (Resize(crop) direct) with features memoized per image — the fast path.
    """
    if args.feature_cache and os.path.exists(args.feature_cache):
        with np.load(args.feature_cache) as f:
            cache = dict(f)
        return lambda name: cache[name]

    if args.image_dir:
        from icee_tpu_torch.data.transforms import (host_decode_resize,
                                                    normalize, train_augment)
        from icee_tpu_torch.models import resnet

        device = device_of(args)
        backbone = resnet.Backbone(tree_to(load_resnet_params(
            args.resnet_weights, getattr(args, "backbone_dtype", "float32")),
            device))
        if args.resnet_weights is None:
            print("WARNING: no --resnet_weights given; backbone is randomly "
                  "initialized (offline smoke mode)")

        @torch.no_grad()
        def backbone_features(x):
            if spatial:
                return backbone.features(x, grid)[1][0].cpu().numpy()
            return backbone(x)[0].cpu().numpy()

        def decoded(name, size):
            return torch.tensor(host_decode_resize(
                os.path.join(args.image_dir, name), size), device=device)[None]

        if augment:
            # bounded LRU of decoded 336px images (~340KB each; 4096 ≈
            # 1.4GB): an unbounded cache runs the host out of memory on
            # large corpora
            img_memo: "OrderedDict" = OrderedDict()
            max_cached = 4096
            generator = torch.Generator(device=device).manual_seed(seed)

            def provider(name):
                if name in img_memo:
                    img_memo.move_to_end(name)
                else:
                    img_memo[name] = decoded(name, resize_size)
                    if len(img_memo) > max_cached:
                        img_memo.popitem(last=False)
                return backbone_features(train_augment(
                    img_memo[name], generator, crop_size=args.crop_size))

            return provider

        memo = {}

        def provider(name):
            if name not in memo:
                memo[name] = backbone_features(
                    normalize(decoded(name, args.crop_size)))
            return memo[name]

        return provider

    print("WARNING: no images or feature cache; using deterministic random "
          "features (offline smoke mode)")
    feat_dim = 2048

    def provider(name):
        rng = np.random.default_rng(zlib.crc32(name.encode()) & 0xFFFFFFFF)
        if spatial:
            return rng.standard_normal((grid * grid, feat_dim)).astype(
                np.float32)
        return rng.standard_normal((feat_dim,)).astype(np.float32)

    return provider


def load_decoder(path: str, device) -> tuple:
    """``--checkpoint_path`` -> (decoder, head) on ``device``: a checkpoint
    directory that the port's trainers (or ``cli/export.py``) wrote.  The
    JAX package's orbax checkpoints raise (the port imports no JAX)."""
    from icee_tpu_torch.checkpoint.ckpt import load_params

    params = load_params(path, device)
    return params["decoder"], params["head"]


def smoke_weights(cfg, device, attention: bool = False) -> tuple:
    """Random (decoder, head) when no checkpoint is given (smoke mode), from
    ``torch.Generator``s seeded 0 and 1, where the JAX CLIs use
    ``jax.random.PRNGKey(0)`` and ``(1)``."""
    from icee_tpu_torch.core.config import EncoderConfig
    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.models import encoder as enc_mod
    from icee_tpu_torch.models import factored_lstm as fl

    init = att_mod.init_factored_att_params if attention else fl.init_params
    dec = init(torch.Generator().manual_seed(0), cfg, device=device)
    head = enc_mod.init_head_params(torch.Generator().manual_seed(1),
                                    EncoderConfig(embed_size=cfg.embed_size),
                                    device=device)
    return dec, head


# --- multi-process runs (icee_tpu_torch/parallel) -------------------------

def add_parallel_flags(p: argparse.ArgumentParser, what: str,
                       multihost: bool = False) -> None:
    """``--data_parallel`` (and, for training, the model axis and JAX's
    three multi-host flags) plus ``--dist_backend``."""
    p.add_argument("--data_parallel", action="store_true",
                   help=f"data-parallel {what} over every rank of the "
                        "world: one process per card, started by "
                        "python -m torch.distributed.run (or, for "
                        "training, the multi-host flags)")
    if multihost:
        p.add_argument("--tensor_parallel", type=int, default=1,
                       help="model-axis size (with --data_parallel): the "
                            "vocabulary of the embedding and the output "
                            "head split over that many ranks")
        p.add_argument("--coordinator_address", type=str, default=None,
                       help="multi-host: host:port of process 0 (with "
                            "--data_parallel, --num_processes and "
                            "--process_id)")
        p.add_argument("--num_processes", type=int, default=None)
        p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="collectives' backend (default: NCCL on CUDA, gloo "
                        "on the CPU); gloo lets two ranks share one card, "
                        "which NCCL refuses")


def refuse_parallel_without_dp(args) -> None:
    """The model axis and the multi-host flags act only with
    ``--data_parallel``, and the coordinator needs the other two: raise
    SystemExit rather than ignore them."""
    stray = [flag for flag, on in (
        ("--tensor_parallel", args.tensor_parallel > 1),
        ("--coordinator_address", args.coordinator_address is not None),
        ("--num_processes", args.num_processes is not None),
        ("--process_id", args.process_id is not None)) if on]
    if stray and not args.data_parallel:
        raise SystemExit(f"{', '.join(stray)} need --data_parallel")
    if args.coordinator_address is not None and (
            args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator_address needs --num_processes and "
                         "--process_id")


def data_parallel_mesh(args, device: torch.device, what: str, tp: int = 1):
    """``--data_parallel``: start the world (torchrun's environment or the
    multi-host flags, ``parallel/mesh.py::init_distributed``) -> this
    rank's mesh, or None with a WARNING where the world holds one
    process (or without the flag)."""
    if not args.data_parallel:
        return None
    import torch.distributed as dist

    from icee_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from icee_tpu_torch.parallel.train import dp_tp_shape

    init_distributed(getattr(args, "coordinator_address", None),
                     getattr(args, "num_processes", None),
                     getattr(args, "process_id", None),
                     backend=args.dist_backend, device=device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        print(f"WARNING: --data_parallel with a single device; {what} "
              "single-device")
        return None
    shape = dp_tp_shape(n, tp) if tp > 1 else (n, 1)
    return make_mesh(shape, device=device, backend=args.dist_backend)


def end_parallel(mesh) -> None:
    """Take the world down at the end of a multi-process run."""
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
