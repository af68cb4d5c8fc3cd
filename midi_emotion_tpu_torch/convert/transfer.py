"""Cross-config weight transfer, over a ``state_dict``.

Counterpart of ``midi_emotion_tpu/convert/transfer.py`` (the reference's
``src/models/transfer_model.py:30-47``): copy parameters by name from a
trained model into a freshly initialized model of a (possibly different)
config. The token embedding of another width (the conditioning modes
differ by d_condition) or another vocabulary takes the overlapping
``[rows, cols]`` slice; any other leaf whose shape differs keeps its fresh
init. As a CLI, over work dirs in either layout:

    python -m midi_emotion_tpu_torch.convert.transfer --from_dir A --to_dir B

which rewrites B's weights in B's own layout (model.msgpack in a native
dir, model.pt in a reference dir).
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch


def transfer_state_dict(src: Dict[str, torch.Tensor],
                        dst: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``dst`` with ``src``'s tensors wherever the names match: the same
    shape copies (in dst's dtype), ``embedding.weight`` of another shape
    copies its overlapping slice into dst's table, and anything else keeps
    dst's tensor."""
    out = {}
    for name, d in dst.items():
        s = src.get(name)
        if s is None:
            out[name] = d
        elif s.shape == d.shape:
            out[name] = s.detach().to(device=d.device, dtype=d.dtype, copy=True)
        elif name == "embedding.weight":
            rows, cols = min(s.shape[0], d.shape[0]), min(s.shape[1], d.shape[1])
            t = d.detach().clone()
            t[:rows, :cols] = s[:rows, :cols].to(device=d.device, dtype=d.dtype)
            out[name] = t
        else:
            out[name] = d  # incompatible: keep the fresh init
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Transfer weights across configs")
    ap.add_argument("--from_dir", required=True, help="trained model dir (either layout)")
    ap.add_argument("--to_dir", required=True,
                    help="target work dir (either layout, e.g. from a 1-step training run); "
                    "its weights are rewritten in its own layout")
    ap.add_argument("--device", default="cuda", help="torch device to load onto (cuda, cpu)")
    args = ap.parse_args(argv)

    from ..training.checkpoint import save_checkpoint
    from . import load_model_dir

    _, src, _ = load_model_dir(args.from_dir, device=args.device)
    dst_cfg, dst, dst_vocab = load_model_dir(args.to_dir, device=args.device)
    dst.load_state_dict(transfer_state_dict(src.state_dict(), dst.state_dict()))
    save_checkpoint(args.to_dir, dst, dst_cfg, dst_vocab)
    print(f"Transferred {args.from_dir} -> {args.to_dir}")
    return dst


if __name__ == "__main__":
    main()
