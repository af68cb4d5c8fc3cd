"""Torch port, the modules beside the model: weight transfer and export,
the offline data pipeline (preprocess, dataset_builder, msd_hdf5), utils,
the ``MIDI_EMOTION_FLASH_BWD=xla`` backward, the demo and the entry point,
each held to its JAX counterpart on the same inputs, after the JAX
package's own tests (tests/test_preprocess_and_transfer.py,
test_dataset_builder.py, test_msd_hdf5.py, test_utils_and_mesh.py)."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401 -- pins JAX to the CPU

import jax
import jax.numpy as jnp

from midi_emotion_tpu.convert.torch_export import main as jax_export_main
from midi_emotion_tpu.convert.transfer import transfer_params
from midi_emotion_tpu.data import dataset_builder as jdb
from midi_emotion_tpu.data import midi_io as jmidi_io
from midi_emotion_tpu.data import msd_hdf5 as jmsd
from midi_emotion_tpu.data import preprocess as jpre
from midi_emotion_tpu.data.features import preprocess_features as jax_preprocess_features
from midi_emotion_tpu.models.model import init_params
from midi_emotion_tpu.models.model import MusicTransformer as JaxMusicTransformer
from midi_emotion_tpu.ops import pallas_attention
from midi_emotion_tpu.training import checkpoint as jckpt
from midi_emotion_tpu.utils import split_list as jax_split_list
from midi_emotion_tpu.vocab import DEFAULT_VOCAB as JAX_VOCAB
from midi_emotion_tpu_torch import demo, entry, utils
from midi_emotion_tpu_torch.convert import load_model_dir, state_dict_from_jax_params
from midi_emotion_tpu_torch.convert import torch_export, transfer
from midi_emotion_tpu_torch.data import dataset_builder as tdb
from midi_emotion_tpu_torch.data import msd_hdf5 as tmsd
from midi_emotion_tpu_torch.data import preprocess as tpre
from midi_emotion_tpu_torch.data.features import preprocess_features
from midi_emotion_tpu_torch.data.loader import load_song_shard
from midi_emotion_tpu_torch.ops import flash_attention as fa

from torch_parity import config_pair, generic_interpret

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_layer=2, n_head=4, d_model=64, d_inner=128, d_condition=16, max_seq=128,
            dropout=0.0)


# ---------------------------------------------------------------------------
# transfer and export
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params(mode, vocab_size, seed, max_seq=128):
    """(JAX config, the port's config, JAX init params). max_seq 2048 for
    a model that goes through the reference layout, whose config fixes it
    (build_model.py:22)."""
    jcfg, tcfg = config_pair(vocab_size=vocab_size, mode=mode, **{**TINY, "max_seq": max_seq})
    return jcfg, tcfg, jax.device_get(init_params(JaxMusicTransformer(jcfg),
                                                  jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("src,dst", [
    (("none", 1007), ("none", 1007)),  # same config
    (("none", 1007), ("continuous_concat", 1007)),  # embedding-width slice
    (("none", 1007), ("none", 1017)),  # vocab growth
])
def test_transfer_state_dict_matches_transfer_params(src, dst):
    """Bitwise after the name map, in the three cases of
    tests/test_preprocess_and_transfer.py."""
    _, scfg, a = _params(*src, 0)
    _, dcfg, b = _params(*dst, 1)
    want = state_dict_from_jax_params(transfer_params(a, b), dcfg)
    got = transfer.transfer_state_dict(state_dict_from_jax_params(a, scfg),
                                       state_dict_from_jax_params(b, dcfg))
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    fresh = state_dict_from_jax_params(b, dcfg)
    if src != dst:  # the slice landed and the incompatible head kept its init
        emb = got["embedding.weight"]
        rows, cols = min(emb.shape[0], 1007), min(emb.shape[1], 64)
        assert torch.equal(emb[:rows, :cols],
                           state_dict_from_jax_params(a, scfg)["embedding.weight"][:rows, :cols])
    if dst[1] != src[1]:
        assert torch.equal(got["fc.weight"], fresh["fc.weight"])


@pytest.mark.parametrize("to_layout", ["native", "reference"])
def test_transfer_cli_writes_the_target_dirs_layout(tmp_path, to_layout):
    """A trained continuous_concat native dir into a fresh continuous_token
    dir of either layout: the dir keeps its layout and holds
    transfer_state_dict's weights."""
    jcfg_a, _, a = _params("continuous_concat", 1007, 0, 2048)
    jcfg_b, tcfg_b, b = _params("continuous_token", 1007, 1, 2048)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    jckpt.save_checkpoint(src, a, jcfg_a, JAX_VOCAB)
    if to_layout == "native":
        jckpt.save_checkpoint(dst, b, jcfg_b, JAX_VOCAB)
    else:
        from midi_emotion_tpu_torch.convert import save_reference_dir
        from midi_emotion_tpu_torch.vocab import DEFAULT_VOCAB

        save_reference_dir(dst, tcfg_b, state_dict_from_jax_params(b, tcfg_b), DEFAULT_VOCAB)
    before = sorted(os.listdir(dst))
    transfer.main(["--from_dir", src, "--to_dir", dst, "--device", "cpu"])
    assert sorted(os.listdir(dst)) == before
    got = load_model_dir(dst, device="cpu")[1].state_dict()
    want = state_dict_from_jax_params(transfer_params(a, b), tcfg_b)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_torch_export_matches_jax_cli(tmp_path):
    """A native dir through both packages' torch_export: the same
    model.pt, model_config.pt and mappings.pt."""
    jcfg, _, params = _params("continuous_concat", 1007, 0, 2048)
    src = str(tmp_path / "native")
    jckpt.save_checkpoint(src, params, jcfg, JAX_VOCAB)
    jax_export_main(["--model_dir", src, "--out_dir", str(tmp_path / "jax")])
    torch_export.main(["--model_dir", src, "--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    load = lambda d, f: torch.load(str(tmp_path / d / f), weights_only=False)
    want, got = load("jax", "model.pt"), load("port", "model.pt")
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for f in ("model_config.pt", "mappings.pt"):
        assert load("port", f) == load("jax", f), f
    load_model_dir(str(tmp_path / "port"), device="cpu")  # and the export loads


# ---------------------------------------------------------------------------
# the offline data pipeline
# ---------------------------------------------------------------------------


def _write_roll(path, seed=0, steps=96 * 6):
    rng = np.random.RandomState(seed)
    rolls = {}
    for name in ("PIANO", "BASS", "DRUMS"):
        roll = np.zeros((steps, 128), np.uint8)
        for _ in range(25):
            t = rng.randint(0, steps - 12)
            p = rng.randint(30, 100)
            roll[t : t + rng.randint(2, 12), p] = 100
        rolls[name] = roll
    jmidi_io.save_pianoroll_npz(path, rolls)


def test_preprocess_matches_jax(tmp_path):
    """Both packages' preprocess CLI over the same pianorolls: the same
    shards and vocab.json; a file that fails gives None in both."""
    src = tmp_path / "rolls"
    os.makedirs(src)
    for i in range(3):
        _write_roll(str(src / f"s{i}.npz"), seed=i)
    for name, main in (("jax", jpre.main), ("port", tpre.main)):
        os.makedirs(tmp_path / name)
        main(["--input_dir", str(src), "--out_dir", str(tmp_path / name / "shards"),
              "--n_workers", "1"])
    shards = sorted(os.listdir(tmp_path / "jax" / "shards"))
    assert len(shards) == 3 and sorted(os.listdir(tmp_path / "port" / "shards")) == shards
    for f in shards:
        want = load_song_shard(str(tmp_path / "jax" / "shards" / f))
        got = load_song_shard(str(tmp_path / "port" / "shards" / f))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (tmp_path / "port" / "vocab.json").read_text() == \
        (tmp_path / "jax" / "vocab.json").read_text()
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, garbage=np.zeros(3))
    assert tpre.process_song((bad, "bad", str(tmp_path))) is None
    assert jpre.process_song((bad, "bad", str(tmp_path))) is None


class FakeSpotify:
    """The spotipy surface stage 3 calls; nothing leaves the process."""

    def tracks(self, ids):
        return {"tracks": [{"uri": f"spotify:track:{i}", "name": f"song {i}",
                            "artists": [{"name": "artist"}], "album": {"name": f"album {i}"}}
                           for i in ids]}

    def audio_features(self, ids):
        return [{"valence": 0.42, "energy": 0.5} for _ in ids]


def test_dataset_builder_matches_jax(tmp_path):
    """String matching, match reversal and filtering, dedup, MIDI features,
    summarize and the stage-3 loop (a fake client) against the JAX copy."""
    for a, b in (("Hello_World (live) ", "hello world!"), ("Don's Song", "dons song"),
                 ("A", ""), ("Track (remix) [edit]", "track"), ("abcd", "abXd")):
        assert tdb.fix_string(a) == jdb.fix_string(a)
        assert tdb.strip_artist(a) == jdb.strip_artist(a)
        assert tdb.matching_strings_flexible(a, b) == jdb.matching_strings_flexible(a, b)
    scores = {"TR1": {"fileA": 0.9, "fileB": 0.5}, "TR2": {"fileA": 0.95}}
    rev = tdb.reverse_match_scores(scores)
    assert rev == jdb.reverse_match_scores(scores) and list(rev["fileA"]) == ["TR2", "TR1"]
    assert tdb.best_match_scores(rev) == jdb.best_match_scores(rev)
    f2h = {"a": "h1", "b": "h1", "c": "h2", "d": "empty_pianoroll"}
    assert tdb.unique_files(f2h, {"b": ("TR", 0.9)}) == jdb.unique_files(f2h, {"b": ("TR", 0.9)})
    paths = [str(tmp_path / f"{n}.npz") for n in "abc"]
    for p, seed in zip(paths, (1, 1, 2)):
        _write_roll(p, seed)
    for p in paths:
        assert tdb.pianoroll_content_hash(p) == jdb.pianoroll_content_hash(p)
        assert tdb.midi_features_from_pianoroll(p) == jdb.midi_features_from_pianoroll(p)
    t2s = {"TR1": {"song_id": "SO1", "title": "t1", "artist": "a", "release": "r"},
           "TR2": {"song_id": "SO2", "title": "t2", "artist": "a", "release": "r"}}
    s2sp = {"SO1": ["id1"], "SO2": []}
    got = tdb.fetch_spotify_features(t2s, s2sp, FakeSpotify(), str(tmp_path / "t.csv"))
    want = jdb.fetch_spotify_features(t2s, s2sp, FakeSpotify(), str(tmp_path / "j.csv"))
    assert got == want and got["TR1"]["spotify_audio_features"]["valence"] == 0.42
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_summary_csv_reads_back_through_both_packages(tmp_path):
    """write_summary_csv without pandas writes the bytes the JAX copy's
    pandas writes; through both packages' preprocess_features the rows
    agree, the labels to 1e-12: pandas' default CSV float parser may miss
    the correctly rounded value of a 17-digit field by an ulp, where the
    port's float() does not."""
    merged = {}
    rng = np.random.RandomState(0)
    for i in range(30):
        matched = {} if i % 5 == 0 else {"spotify_audio_features": {
            "valence": 0.0 if i % 7 == 0 else float(rng.uniform(0.01, 1))}}
        merged[f"f{i:02d}"] = {"midi_features": {"note_density": float(rng.uniform(1, 9)),
                                                 "n_instruments": int(rng.randint(0, 5)),
                                                 "tempo": 120, "duration": 60},
                               "matched_features": matched}
    rows = tdb.summarize(merged)
    assert repr(rows) == repr(jdb.summarize(merged))
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    tdb.write_summary_csv(rows, port_csv)
    jdb.write_summary_csv(rows, jax_csv)
    assert open(port_csv).read() == open(jax_csv).read()
    for n_bins in (None, 5):
        for labeled_only in (True, False):
            kw = dict(n_bins=n_bins, use_labeled_only=labeled_only)
            want = jax_preprocess_features(jax_csv, **kw)
            got = preprocess_features(port_csv, **kw)
            assert [[r["file"] for r in part] for part in got] == \
                [[r["file"] for r in part] for part in want]
            assert sum(map(len, want)) > 3
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                for key in ("valence", "arousal"):
                    if n_bins is None and w[key] is not None:
                        assert abs(g[key] - w[key]) <= 1e-12, (w["file"], key)
                    else:
                        assert g[key] == w[key], (w["file"], key)


@pytest.fixture()
def msd_file(tmp_path):
    """A three-song aggregate file in the MSD layout (compound songs
    tables with idx_* columns, variable-length arrays beside them)."""
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "msd_summary.h5")
    terms_idx, seg_idx = np.array([0, 2, 5]), np.array([0, 4, 6])
    meta_dt = np.dtype([("artist_name", "S32"), ("title", "S32"), ("release", "S32"),
                        ("song_id", "S32"), ("artist_familiarity", "<f8"),
                        ("idx_artist_terms", "<i4")])
    ana_dt = np.dtype([("track_id", "S32"), ("tempo", "<f8"), ("idx_segments_start", "<i4"),
                       ("idx_segments_pitches", "<i4")])
    mb_dt = np.dtype([("year", "<i4"), ("idx_artist_mbtags", "<i4")])
    with h5py.File(path, "w") as h5:
        meta = np.zeros(3, meta_dt)
        for i in range(3):
            meta[i] = (b"artist%d" % i, b"title%d" % i, b"release%d" % i, b"SO%d" % i,
                       0.1 + 0.4 * i, terms_idx[i])
        h5.create_dataset("metadata/songs", data=meta)
        h5.create_dataset("metadata/artist_terms", data=np.array([b"t%d" % i for i in range(6)]))
        ana = np.zeros(3, ana_dt)
        for i in range(3):
            ana[i] = (b"TR%d" % i, 90.0 + 30 * i, seg_idx[i], seg_idx[i])
        h5.create_dataset("analysis/songs", data=ana)
        h5.create_dataset("analysis/segments_start", data=np.arange(9, dtype=np.float64))
        h5.create_dataset("analysis/segments_pitches",
                          data=np.random.RandomState(0).rand(9, 12))
        mb = np.zeros(3, mb_dt)
        mb["year"], mb["idx_artist_mbtags"] = [1990, 2000, 2010], [0, 1, 2]
        h5.create_dataset("musicbrainz/songs", data=mb)
        h5.create_dataset("musicbrainz/artist_mbtags", data=np.array([b"a", b"b", b"c"]))
    return path


def test_msd_hdf5_matches_jax(msd_file):
    """Every getter the file can serve, per song, against the JAX copy;
    the pytables-style columns read lazily (only the rows indexed)."""
    assert tmsd.getter_names() == jmsd.getter_names()
    names = ("artist_name", "title", "release", "song_id", "artist_familiarity", "track_id",
             "tempo", "year", "artist_terms", "segments_start", "segments_pitches",
             "artist_mbtags")
    with tmsd.open_h5_file_read(msd_file) as th, jmsd.open_h5_file_read(msd_file) as jh:
        assert tmsd.get_num_songs(th) == jmsd.get_num_songs(jh) == 3
        for i in range(3):
            for name in names:
                got = getattr(tmsd, f"get_{name}")(th, i)
                want = getattr(jmsd, f"get_{name}")(jh, i)
                np.testing.assert_array_equal(got, want, err_msg=f"{name}[{i}]")
                assert np.asarray(got).dtype == np.asarray(want).dtype
        col = th.root.metadata.songs.cols.artist_name
        assert isinstance(col, tmsd._Column) and len(col) == 3
        for key in (1, slice(0, 2), -1):
            np.testing.assert_array_equal(col[key], jh.root.metadata.songs.cols.artist_name[key])
        assert th.root.analysis.songs.cols.tempo[2] == 150.0
        assert th.root.metadata.songs.nrows == 3
        with pytest.raises(AttributeError):
            th.root.metadata.songs.cols.nope
    tdb_meta = tdb.msd_trackid_to_metadata(msd_file, ["TR2", "TR0"])
    assert tdb_meta == jdb.msd_trackid_to_metadata(msd_file, ["TR2", "TR0"])


# ---------------------------------------------------------------------------
# utils, the demo and the entry point
# ---------------------------------------------------------------------------


def test_utils_match_jax(tmp_path):
    for n, parts in ((10, 3), (2, 0), (7, 7), (0, 2)):
        assert utils.split_list(list(range(n)), parts) == jax_split_list(list(range(n)), parts)
    assert utils.split_list(list(range(10)), 3) == [[0, 1, 2], [3, 4, 5], [6, 7, 8, 9]]
    t = utils.StepTimer()
    assert np.isnan(t.ms_per_step)
    t.tick()
    assert t.ms_per_step >= 0
    with utils.profiler_trace(None) as prof:
        assert prof is None
    with utils.profiler_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_demo_runs_its_six_steps_on_the_cpu(tmp_path):
    summary = demo.main(["--out", str(tmp_path / "demo"), "--n_songs", "4", "--steps", "2",
                         "--gen_len", "16", "--n_workers", "1", "--device", "cpu"])
    assert len(summary["midi_files"]) == 2
    assert os.path.exists(os.path.join(summary["model_dir"], "model.pt"))


def test_entry_is_the_flagship_on_the_card():
    """The flagship itself is never built on the CPU: without a card the
    entry point refuses, as every entry point of the port does."""
    assert entry.FLAGSHIP == dict(vocab_size=1007, mode="continuous_concat", n_layer=20,
                                  n_head=16, d_model=768, d_inner=3072, d_condition=192,
                                  max_seq=2048, dropout=0.1)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal path is for CUDA-less machines")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()


# ---------------------------------------------------------------------------
# MIDI_EMOTION_FLASH_BWD=xla
# ---------------------------------------------------------------------------


def test_flash_bwd_xla_matches_jax(monkeypatch):
    """Under MIDI_EMOTION_FLASH_BWD=xla in both packages: dQ, dK, dV and dE
    to 1e-5 in f32, a pad tail included; the kernel backward (its twin on
    the CPU) is not called."""
    monkeypatch.setenv("MIDI_EMOTION_FLASH_BWD", "xla")
    B, H, T, dh, max_seq = 2, 2, 40, 48, 128
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(4))
    e = rng.standard_normal((max_seq, dh)).astype(np.float32)
    pk = np.zeros((B, T), bool)
    pk[1, -10:] = True

    def loss(q_, k_, v_, e_):
        out = pallas_attention.flash_relative_attention(q_, k_, v_, e_, True, jnp.asarray(pk))
        return jnp.sum(out * g)

    with generic_interpret():
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, e)))

    def kernel_backward(*args):
        raise AssertionError("the kernel backward ran under MIDI_EMOTION_FLASH_BWD=xla")

    monkeypatch.setattr(fa, "flash_rel_attention_bwd", kernel_backward)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, e)]
    o, _ = fa.flash_rel_attention(*leaves, True, torch.from_numpy(pk))
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "de"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=name)


def test_flash_bwd_bad_value_raises_at_import_and_backward(monkeypatch):
    env = dict(os.environ, MIDI_EMOTION_FLASH_BWD="jax",
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c",
                           "import midi_emotion_tpu_torch.ops.flash_attention"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "MIDI_EMOTION_FLASH_BWD" in proc.stderr
    x = torch.randn((1, 1, 8, 16), requires_grad=True)
    o, _ = fa.flash_rel_attention(x, x, x, torch.randn((16, 16)), True, None)
    monkeypatch.setenv("MIDI_EMOTION_FLASH_BWD", "XLA")
    with pytest.raises(ValueError, match="MIDI_EMOTION_FLASH_BWD"):
        o.sum().backward()
