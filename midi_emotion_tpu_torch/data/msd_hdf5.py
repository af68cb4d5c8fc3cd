"""Million Song Dataset HDF5 accessors (h5py, table-driven).

API-parity replacement for the GPL pytables accessor library the reference
vendors (the reference's src/create_dataset/hdf5_getters.py:34-480, 54
``get_*`` functions + ``open_h5_file_read`` + ``get_num_songs``). This is a
clean-room implementation: the MSD file layout (three groups --
``metadata``, ``analysis``, ``musicbrainz`` -- each holding a compound
``songs`` table, with variable-length per-song arrays stored beside it and
indexed by ``idx_<name>`` columns) is a documented data format, and every
getter here is generated from one declarative field table over h5py
instead of 54 hand-written pytables functions.

Semantics matched to the reference:

* scalar getters read column ``name`` of ``<group>/songs`` at ``songidx``
  (hdf5_getters.py:49-53 and friends);
* array getters slice ``<group>/<name>`` between this song's
  ``idx_<name>`` and the next song's (or to the end for the last song) --
  the aggregate-file convention (hdf5_getters.py:145-154);
* 2-D arrays (``segments_pitches``, ``segments_timbre``) keep their
  trailing feature axis (hdf5_getters.py:307-328);
* ``get_num_songs`` is the row count of ``metadata/songs``
  (hdf5_getters.py:42-47).

``open_h5_file_read`` returns an ``h5py.File`` (a context manager); it is
interchangeable with the reference's handle ONLY through these getters,
not through pytables ``h5.root`` attribute access.

A copy of ``midi_emotion_tpu/data/msd_hdf5.py`` (the torch port keeps its
own copies and imports nothing of the JAX package), unchanged but for this
note, the reference's paths, given from its repository root, and
``_ColsView``: its columns read only the rows they are indexed with, where
the JAX copy reads the whole column on every attribute access. h5py is
imported lazily, as there.
"""

from __future__ import annotations

import functools
import sys

# (group, name, kind) -- kind "scalar": column of <group>/songs;
# "array": dataset <group>/<name> with idx_<name> column; "array2d": same
# with a trailing feature axis.
_FIELDS = [
    ("metadata", "artist_familiarity", "scalar"),
    ("metadata", "artist_hotttnesss", "scalar"),
    ("metadata", "artist_id", "scalar"),
    ("metadata", "artist_mbid", "scalar"),
    ("metadata", "artist_playmeid", "scalar"),
    ("metadata", "artist_7digitalid", "scalar"),
    ("metadata", "artist_latitude", "scalar"),
    ("metadata", "artist_longitude", "scalar"),
    ("metadata", "artist_location", "scalar"),
    ("metadata", "artist_name", "scalar"),
    ("metadata", "release", "scalar"),
    ("metadata", "release_7digitalid", "scalar"),
    ("metadata", "song_id", "scalar"),
    ("metadata", "song_hotttnesss", "scalar"),
    ("metadata", "title", "scalar"),
    ("metadata", "track_7digitalid", "scalar"),
    ("metadata", "similar_artists", "array"),
    ("metadata", "artist_terms", "array"),
    ("metadata", "artist_terms_freq", "array"),
    ("metadata", "artist_terms_weight", "array"),
    ("analysis", "analysis_sample_rate", "scalar"),
    ("analysis", "audio_md5", "scalar"),
    ("analysis", "danceability", "scalar"),
    ("analysis", "duration", "scalar"),
    ("analysis", "end_of_fade_in", "scalar"),
    ("analysis", "energy", "scalar"),
    ("analysis", "key", "scalar"),
    ("analysis", "key_confidence", "scalar"),
    ("analysis", "loudness", "scalar"),
    ("analysis", "mode", "scalar"),
    ("analysis", "mode_confidence", "scalar"),
    ("analysis", "start_of_fade_out", "scalar"),
    ("analysis", "tempo", "scalar"),
    ("analysis", "time_signature", "scalar"),
    ("analysis", "time_signature_confidence", "scalar"),
    ("analysis", "track_id", "scalar"),
    ("analysis", "segments_start", "array"),
    ("analysis", "segments_confidence", "array"),
    ("analysis", "segments_pitches", "array2d"),
    ("analysis", "segments_timbre", "array2d"),
    ("analysis", "segments_loudness_max", "array"),
    ("analysis", "segments_loudness_max_time", "array"),
    ("analysis", "segments_loudness_start", "array"),
    ("analysis", "sections_start", "array"),
    ("analysis", "sections_confidence", "array"),
    ("analysis", "beats_start", "array"),
    ("analysis", "beats_confidence", "array"),
    ("analysis", "bars_start", "array"),
    ("analysis", "bars_confidence", "array"),
    ("analysis", "tatums_start", "array"),
    ("analysis", "tatums_confidence", "array"),
    ("musicbrainz", "artist_mbtags", "array"),
    ("musicbrainz", "artist_mbtags_count", "array"),
    ("musicbrainz", "year", "scalar"),
]


class _ColsView:
    """pytables ``table.cols``: attribute access to a compound dataset's
    columns (each column indexable like ``cols.artist_name[songidx]``)."""

    def __init__(self, dataset):
        self._ds = dataset

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in (self._ds.dtype.names or ()):
            raise AttributeError(f"no column {name!r}")
        return _Column(self._ds, name)


class _Column:
    """One column of a compound dataset, read lazily: indexing reads only
    the rows it selects (pytables' Column reads the same way)."""

    def __init__(self, dataset, name):
        self._ds, self._name = dataset, name

    def __getitem__(self, key):
        return self._ds.fields(self._name)[key]

    def __len__(self):
        return self._ds.shape[0]


class _NodeView:
    """pytables node: ``h5.root.metadata.songs`` style attribute walking
    over an h5py group tree, with ``.nrows``/``.cols`` on table nodes."""

    def __init__(self, node):
        self._node = node

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        import h5py

        if name == "cols" and isinstance(self._node, h5py.Dataset):
            return _ColsView(self._node)
        if name == "nrows" and isinstance(self._node, h5py.Dataset):
            return self._node.shape[0]
        try:
            child = self._node[name]
        except KeyError:
            raise AttributeError(name) from None
        if isinstance(child, h5py.Dataset) and child.dtype.names is None:
            return child  # array node: slice it directly, like pytables
        return _NodeView(child)

    def __getitem__(self, key):  # table nodes are row-indexable too
        return self._node[key]


class _H5Handle:
    """Read handle matching BOTH access styles: the h5py path style every
    getter in this module uses (``h5["metadata/songs"]``) and the
    reference's pytables attribute style (``h5.root.metadata.songs.nrows``,
    ``...songs.cols.artist_name[idx]``, hdf5_getters.py:33-53). PARITY §3b
    interop, closing the one place a reference-style caller touching
    ``h5.root`` directly would have broken."""

    def __init__(self, f):
        self._f = f
        self.root = _NodeView(f)

    def __getitem__(self, key):
        return self._f[key]

    def __contains__(self, key):
        return key in self._f

    def __getattr__(self, name):  # close(), attrs, filename, ...
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False


def open_h5_file_read(h5filename):
    """Open an MSD .h5 file read-only. Returns a handle usable with every
    getter in this module, as a context manager, and via the reference's
    pytables-style ``h5.root`` attribute access."""
    import h5py

    return _H5Handle(h5py.File(h5filename, "r"))


def get_num_songs(h5) -> int:
    """Number of songs in the file (rows of the metadata songs table)."""
    return h5["metadata/songs"].shape[0]


def _scalar(h5, group: str, name: str, songidx: int):
    return h5[f"{group}/songs"][name][songidx]


def _array(h5, group: str, name: str, songidx: int):
    songs = h5[f"{group}/songs"]
    idx = songs[f"idx_{name}"]
    data = h5[f"{group}/{name}"]
    lo = idx[songidx]
    if songs.shape[0] == songidx + 1:
        return data[lo:]
    return data[lo : idx[songidx + 1]]


def _make_getter(group: str, name: str, kind: str):
    if kind == "scalar":
        def getter(h5, songidx: int = 0):
            return _scalar(h5, group, name, songidx)

        getter.__doc__ = (
            f"{name} for song ``songidx`` (column of ``{group}/songs``)."
        )
    else:
        def getter(h5, songidx: int = 0):
            return _array(h5, group, name, songidx)

        getter.__doc__ = (
            f"{name} array for song ``songidx`` (``{group}/{name}`` rows "
            f"``idx_{name}[songidx] : idx_{name}[songidx+1]``, aggregate-"
            "file convention)."
        )
    getter.__name__ = f"get_{name}"
    getter.__qualname__ = getter.__name__
    return getter


_mod = sys.modules[__name__]
for _group, _name, _kind in _FIELDS:
    setattr(_mod, f"get_{_name}", _make_getter(_group, _name, _kind))
del _mod, _group, _name, _kind


@functools.lru_cache(maxsize=1)
def getter_names() -> tuple:
    """All getter names, for API-surface tests."""
    return tuple(sorted(f"get_{name}" for _, name, _ in _FIELDS))
