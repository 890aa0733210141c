"""``python -m icee_tpu_torch.cli.export`` — checkpoint exporter (reference
``stylenet/exporter.py:17-40``, SURVEY X1; port of
``icee_tpu/cli/export.py``): wrap a reference torch decoder (and encoder)
checkpoint — a state dict or a whole-module pickle — or the params of a port
checkpoint into the port's full checkpoint format, with fresh Adam states
and the BLEU bookkeeping, so that it can resume training or feed the
serving registry."""

import argparse


def main(args) -> None:
    from icee_tpu_torch.checkpoint import torch_import as ti
    from icee_tpu_torch.checkpoint.torch_pickle import load_state_dict
    from icee_tpu_torch.checkpoint.ckpt import (CheckpointState,
                                                save_checkpoint)
    from icee_tpu_torch.cli import common
    from icee_tpu_torch.core.config import TrainConfig
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.serve.engine import TORCH_CKPT
    from icee_tpu_torch.train import optim

    device = common.device_of(args)
    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    tcfg = TrainConfig()

    if args.decoder_path.endswith(TORCH_CKPT):
        dec = common.tree_to(ti.import_factored_decoder_state_dict(
            load_state_dict(args.decoder_path)), device)
        if args.encoder_path:
            enc_sd = load_state_dict(args.encoder_path)
            head = common.tree_to(ti.import_encoder_head_state_dict(
                {k: v for k, v in enc_sd.items()
                 if not k.startswith("resnet.")}), device)
        else:
            head = common.smoke_weights(cfg, device)[1]
    else:
        dec, head = common.load_decoder(args.decoder_path, device)

    optimizer = optim.make_adam(tcfg.lr_caption, tcfg)
    lang = optim.make_adam(tcfg.lr_language, tcfg)
    state = CheckpointState(
        epoch=args.epoch,
        epochs_since_improvement={"factual": 0, "emotion": 0},
        best_bleu4={"factual": args.bleu4, "emotion": 0.0},
        params={"decoder": dec, "head": head},
        opt_states={"optimizer": optimizer.init((dec, head)),
                    "lang_optimizer": lang.init(dec)},
    )
    path = save_checkpoint(args.out_dir, args.data_name, args.mode.upper()[:3],
                           state, is_best=args.best)
    print(f"exported full checkpoint to {path}")


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_model_flags

    p = argparse.ArgumentParser()
    p.add_argument("--decoder_path", type=str, required=True)
    p.add_argument("--encoder_path", type=str, default=None)
    p.add_argument("--vocab_path", type=str, required=True)
    p.add_argument("--out_dir", type=str, default="models/")
    p.add_argument("--data_name", type=str, default="flickr8k_id")
    p.add_argument("--mode", type=str, default="factual")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--bleu4", type=float, default=0.0)
    p.add_argument("--best", action="store_true")
    add_model_flags(p)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
