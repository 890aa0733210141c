"""``python -m icee_tpu_torch.cli.inspect_ckpt`` — checkpoint inspector
(reference ``stylenet/importer.py:1-33``, SURVEY X2; port of
``icee_tpu/cli/inspect_ckpt.py``): load a checkpoint and print each decoder
leaf beside a fresh-init decoder's, as a manual check that restoring
actually changed the weights.  The fresh init is the port's (a
``torch.Generator`` seeded 0), so its column differs from the JAX CLI's."""

import argparse

import numpy as np


def _summ(x) -> str:
    a = np.asarray(x)
    return (f"shape={tuple(a.shape)} mean={a.mean():+.5f} "
            f"std={a.std():.5f} |max|={np.abs(a).max():.5f}")


def main(args) -> None:
    from icee_tpu_torch import bridge
    from icee_tpu_torch.cli import common
    from icee_tpu_torch.data.vocab import load_vocab

    device = common.device_of(args)
    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    fresh = bridge.to_numpy(common.smoke_weights(cfg, device)[0])
    dec = bridge.to_numpy(common.load_decoder(args.checkpoint_path,
                                              device)[0])
    print(f"{'param':12s} {'loaded':60s} {'fresh init':60s} same?")
    for name in sorted(fresh):
        same = np.allclose(dec[name], fresh[name])
        print(f"{name:12s} {_summ(dec[name]):60s} {_summ(fresh[name]):60s} "
              f"{same}")


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_model_flags

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_path", type=str, required=True)
    p.add_argument("--vocab_path", type=str, required=True)
    add_model_flags(p)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
