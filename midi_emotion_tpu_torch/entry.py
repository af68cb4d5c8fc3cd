"""Entry point: the flagship's forward step, on the card.

Counterpart of the JAX package's ``__graft_entry__.entry`` (the repository
root's ``__graft_entry__.py:15-44``): the flagship model
(continuous_concat, 20 layers, d_model 768, 16 heads; the reference's
default config, config.py:13-23) with random weights from seed 0, f32
parameters computing in bf16, and its inputs at B 4, T 1216.

    fwd, args = entry()
    logits = fwd(*args)   # [4, 1216, 1007]
"""

from __future__ import annotations

FLAGSHIP = dict(vocab_size=1007, mode="continuous_concat", n_layer=20, n_head=16, d_model=768,
                d_inner=3072, d_condition=192, max_seq=2048, dropout=0.1)


def entry(device="cuda"):
    """-> (fwd, (model, tokens, condition)): ``fwd`` runs the eval forward
    pass (no dropout) without autograd. ``device`` as in
    ``MusicTransformer``: the card unless the caller says otherwise."""
    import torch

    from .models.config import ModelConfig
    from .models.model import MusicTransformer

    model = MusicTransformer(ModelConfig(**FLAGSHIP), dtype=torch.bfloat16, device=device,
                             param_dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    tokens = torch.zeros((4, 1216), dtype=torch.long, device=model.device)
    condition = torch.zeros((4, 2), dtype=torch.float32, device=model.device)

    @torch.inference_mode()
    def fwd(model, tokens, condition):
        return model(tokens, condition)

    return fwd, (model, tokens, condition)
