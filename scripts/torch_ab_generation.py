"""Generation tokens/sec of the torch port at one checkout root, for
comparing two commits inside one call on one card.

    python3 scripts/torch_ab_generation.py <checkout root> <label>

Builds a random-init flagship (continuous_concat, 20 layers, d_model 768,
bf16) with that checkout's ``midi_emotion_tpu_torch`` on the card, warms up
with a 40-token generation, then times ``Sampler.generate`` at B 4 (500
tokens) and B 64 (300 tokens), window 1216, top-p 0.7, and prints one
``AB <label> ...`` line for each. Run the two roots in turns (parent,
change, change, parent) in one call: the card's host speed varies between
calls.
"""
import os, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
os.chdir(root)
import numpy as np, torch
from midi_emotion_tpu_torch.models.model import ModelConfig, MusicTransformer
from midi_emotion_tpu_torch.generation.sampler import Sampler
from midi_emotion_tpu_torch.ops.sampling import SamplingParams
try:
    from midi_emotion_tpu_torch.vocab import Vocab
except ImportError:  # a checkout whose port still took Vocab from the JAX package
    from midi_emotion_tpu.vocab import Vocab
cfg = ModelConfig(vocab_size=1007, mode="continuous_concat", n_layer=20, n_head=16, d_model=768,
                  d_inner=3072, d_condition=192, max_seq=2048, dropout=0.1)
model = MusicTransformer(cfg, dtype=torch.bfloat16, device="cuda").init_weights(torch.Generator().manual_seed(0)).eval()
vocab = Vocab()
def run(B, gen_len):
    sp = SamplingParams(gen_len=gen_len, max_input_len=1216, top_p=0.7, seed=1)
    cond = np.tile(np.array([[0.8, 0.8]], np.float32), (B, 1))
    torch.cuda.synchronize(); t0 = time.perf_counter()
    Sampler(model, vocab, sp).generate(np.full((B, 1), vocab.start_id, np.int32), continuous_conditions=cond)
    torch.cuda.synchronize(); s = time.perf_counter() - t0
    return B * (gen_len - 1) / s, s
run(4, 40)
for B, n in ((4, 500), (64, 300)):
    tps, s = run(B, n)
    print(f"AB {sys.argv[2]} B={B} gen_len={n}: {tps:.1f} tokens/s ({s:.2f} s)", flush=True)
