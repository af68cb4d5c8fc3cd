"""High-level generation API, in torch.

Counterpart of ``midi_emotion_tpu/generation/generate.py``: assembles the
batch from conditions and primers, runs the sampler (KV-cached, or a full
forward per token for per-step conditions), then
post-processes each sample (instrument-count gating with redo lists,
V/A-tagged names) and writes the MIDI file, the token text (``txt_``) and
the raw ids (``inds_``) through the port's copies of ``data/codec.py`` and
``data/midi_io.py``.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import codec, midi_io
from ..models.model import MusicTransformer
from ..ops.sampling import SamplingParams
from ..vocab import Vocab
from .sampler import Sampler


def emotion_bins(n_bins: int = 5) -> np.ndarray:
    """Bin edges for discrete conditions (reference generate.py:320)."""
    return np.linspace(-1 - 1e-12, 1 + 1e-12, num=n_bins + 1)


def bin_symbols(n_bins: int = 5) -> Tuple[List[str], List[str]]:
    """<V..>/<A..> symbols in bin order (reference generate.py:321-328)."""
    if n_bins % 2 == 0:
        bin_ids = list(range(-n_bins // 2, 0)) + list(range(1, n_bins // 2 + 1))
    else:
        bin_ids = list(range(-(n_bins - 1) // 2, (n_bins - 1) // 2 + 1))
    return [f"<V{b}>" for b in bin_ids], [f"<A{b}>" for b in bin_ids]


def continuous_to_discrete_symbols(
    conditions: Sequence[Sequence[float]], n_bins: int = 5
) -> List[List[str]]:
    """(valence, arousal) -> ["<Vk>", "<Ak>"] (reference generate.py:368-377)."""
    edges = emotion_bins(n_bins)
    v_syms, a_syms = bin_symbols(n_bins)
    out = []
    for v, a in conditions:
        vi = int(np.searchsorted(edges, v, side="right")) - 1
        ai = int(np.searchsorted(edges, a, side="right")) - 1
        out.append([v_syms[vi], a_syms[ai]])
    return out


@torch.inference_mode()
def generate(
    model: MusicTransformer,
    vocab: Vocab,
    out_dir: str,
    conditioning: str,
    discrete_conditions: Optional[List[List[str]]] = None,
    continuous_conditions: Optional[List[List[float]]] = None,
    penalty_coeff: float = 0.5,
    max_input_len: int = 1024,
    gen_len: int = 2048,
    temperatures: Sequence[float] = (1.2, 1.2),
    top_k: int = -1,
    top_p: float = 0.7,
    min_n_instruments: int = 2,
    primers: Optional[List[List[str]]] = None,
    seed: int = -1,
    step: Optional[str] = None,
    short_filename: bool = False,
    debug: bool = False,
    verbose: bool = False,
    slide_hop: Optional[int] = None,
    varying_condition: Optional[Sequence[np.ndarray]] = None,
    kv_dtype: str = "native",
):
    """Generate a batch and write MIDI files.

    The uniforms come from a ``torch.Generator`` on the model's device
    seeded with ``max(0, seed)``. That stream differs from the JAX
    package's for the same seed, so the two packages sample the same tokens
    only when the same uniforms are injected
    (``Sampler.generate(uniforms=...)``).

    ``varying_condition``: optional [valences [B, gen_len], arousals
    [B, gen_len]] per-step interpolation (the reference's generate.py:35-36,
    110-113). It runs ``Sampler.generate_exact``, a full forward per token,
    since per-step conditions invalidate cached K/V.

    Returns (redo_primers, redo_discrete_conditions,
    redo_continuous_conditions) like the reference, so callers can loop
    until every condition produced enough instruments.
    """
    if not debug:
        os.makedirs(out_dir, exist_ok=True)

    maps = vocab.get_maps()
    if primers is None:
        primers = [["<START>"]]

    discrete_prefix_ids = None
    cont = None
    if varying_condition is not None:
        valences, arousals = (np.asarray(a, np.float32) for a in varying_condition)
        if not valences.shape == arousals.shape == (valences.shape[0], gen_len):
            raise ValueError(f"varying_condition: valences {valences.shape} and arousals "
                             f"{arousals.shape} must both be [B, gen_len={gen_len}]")
        batch_size = valences.shape[0]
    elif conditioning == "none":
        batch_size = len(primers)
    elif conditioning == "discrete_token":
        if discrete_conditions is None:
            raise ValueError("discrete_token conditioning needs discrete_conditions")
        discrete_prefix_ids = np.array(
            [[maps["tuple2idx"][s] for s in sample] for sample in discrete_conditions],
            np.int32,
        )
        batch_size = discrete_prefix_ids.shape[0]
    else:
        if continuous_conditions is None:
            raise ValueError(f"{conditioning} conditioning needs continuous_conditions")
        cont = np.asarray(continuous_conditions, np.float32)
        batch_size = cont.shape[0]

    primer_ids = [[maps["tuple2idx"][s] for s in p] for p in primers]
    if len(primer_ids) == 1:
        primer_ids = primer_ids * batch_size
    primer_ids = np.asarray(primer_ids, np.int32)

    sampling = SamplingParams(
        gen_len=gen_len,
        max_input_len=max_input_len,
        temperatures=tuple(float(t) for t in temperatures) or (1.2, 1.2),
        top_k=top_k,
        top_p=top_p,
        penalty_coeff=penalty_coeff,
        seed=seed,
    )
    sampler = Sampler(model, vocab, sampling, slide_hop=slide_hop, kv_dtype=kv_dtype)
    if varying_condition is not None:
        vc = np.stack([valences, arousals], axis=-1)  # [B, gen_len, 2]
        song = sampler.generate_exact(primer_ids, varying_conditions=vc)
    else:
        song = sampler.generate(
            primer_ids,
            continuous_conditions=cont,
            discrete_prefix_ids=discrete_prefix_ids,
        )

    redo_primers: List = []
    redo_discrete: List = []
    redo_continuous: List = []
    for i in range(batch_size):
        if short_filename:
            name = f"{i}"
        else:
            if step is None:
                name = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
            else:
                name = str(step)
            name += f"_{i}"
        if seed > 0:
            name += f"_s{seed}"
        if cont is not None:
            cv = [str(round(float(c), 2)).replace(".", "") for c in cont[i]]
            name += f"_V{cv[0]}_A{cv[1]}"

        ids = song[i]
        n_instruments = codec.n_instruments_from_ids(ids, vocab)
        if n_instruments >= min_n_instruments:
            if not debug:
                tracks = codec.ids_to_tracks(ids, vocab)
                midi_io.write_midi(tracks, os.path.join(out_dir, name + ".mid"))
                with open(os.path.join(out_dir, f"txt_{name}.txt"), "w") as f:
                    f.write("\n".join(codec.ids_to_strings(ids, vocab)))
                np.save(os.path.join(out_dir, f"inds_{name}.npy"), ids)
                if verbose:
                    print(f"Saved to {os.path.join(out_dir, name + '.mid')}")
        else:
            print(f"Only has {n_instruments} instruments, not saving.")
            if conditioning == "none":
                redo_primers.append(primers[i % len(primers)])
                redo_discrete = None
                redo_continuous = None
            elif conditioning == "discrete_token":
                redo_discrete.append(discrete_conditions[i])
                redo_continuous = None
                redo_primers = primers
            else:
                redo_discrete = None
                redo_continuous.append(list(map(float, cont[i])))
                redo_primers = primers

    return redo_primers, redo_discrete, redo_continuous
