"""Export a native work dir to the reference's PyTorch format.

Counterpart of ``midi_emotion_tpu/convert/torch_export.py``: writes
model.pt (the state_dict), model_config.pt (the args dict) and mappings.pt
(the vocabulary maps) through ``save_reference_dir``, so a model the JAX
package trained loads in the reference's build_model/generate
(generate.py:307-348) and in the port's reference-layout readers.

    python -m midi_emotion_tpu_torch.convert.torch_export --model_dir <native_dir> \
        --out_dir <torch_dir>
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export checkpoint to PyTorch format")
    ap.add_argument("--model_dir", required=True, help="native work dir")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--device", default="cuda", help="torch device to load onto (cuda, cpu)")
    args = ap.parse_args(argv)

    from . import load_model_dir, save_reference_dir

    cfg, model, vocab = load_model_dir(args.model_dir, device=args.device)
    save_reference_dir(args.out_dir, cfg, model.state_dict(), vocab)
    print(f"Exported to {args.out_dir}")


if __name__ == "__main__":
    main()
