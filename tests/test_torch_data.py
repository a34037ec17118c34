"""The port's GTEA host layer (``data/gtea.py``, ``data/native_io.py``)
against the JAX package's on the same fake tree, written from numpy
seeds into a temporary directory (``tests/torch_gtea_tree.py``).

Everything here is host numpy and the same libjpeg, so the comparisons
are exact: manifests record by record, the split, the SP pair batches
and the LF clip batches key by key (shuffled with the same seed, with
and without flow images), the flow-image decode of the packed, x/y and
mixed layouts, and ``decode_batch`` at the native size and resized,
through the threaded libjpeg library and through PIL.
"""

import dataclasses
import os

import numpy as np
import pytest

from gaze_tpu.data import gtea as jgtea
from gaze_tpu.data import native_io as jnative
from gaze_tpu_torch.data import gtea, native_io
from tests.torch_gtea_tree import write_tree
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

HW = (24, 32)
VIDEOS = {"Alice_Pizza": 9, "Alice_Salad": 7, "Bob_Burger": 8, "Carl_Snack": 5,
          "Dana_Tea": 6}
# One extraction writes one format; both layouts appear.
FLOWS = {"Alice_Pizza": ("packed", "jpg"), "Alice_Salad": ("xy", "jpg"),
         "Bob_Burger": ("xy", "jpg"), "Carl_Snack": ("packed", "jpg"),
         "Dana_Tea": ("packed", "jpg")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Five videos of four subjects; Carl_Snack has no gaze txt, two have
    fixsac files (I-DT labels the others), three have untracked rows;
    every video has flow images, in both layouts."""
    return write_tree(tmp_path_factory.mktemp("gtea"), VIDEOS, HW, seed=3,
                      fixsac=("Alice_Salad", "Dana_Tea"), no_gaze=("Carl_Snack",),
                      untracked={"Alice_Pizza": (2, 5, 6), "Bob_Burger": (4,),
                                 "Dana_Tea": (0, 1)},
                      flows=FLOWS)


@pytest.fixture(scope="module")
def manifests(root):
    return (gtea.build_manifest(root, native_hw=HW),
            jgtea.build_manifest(root, native_hw=HW))


def records(m, videos=None):
    return [r for v in (videos or m.videos) for r in m.frames[v]]


def as_tuples(recs):
    return [dataclasses.astuple(r) for r in recs]


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_manifest_matches_jax(manifests):
    ours, theirs = manifests
    assert ours.videos == theirs.videos == sorted(VIDEOS)
    assert ours.native_hw == theirs.native_hw and ours.subjects() == theirs.subjects()
    for v in ours.videos:
        assert as_tuples(ours.frames[v]) == as_tuples(theirs.frames[v]), v
    # the round-5 cases: a video without gaze txt keeps its frames, all
    # invalid; untracked and out-of-frame rows are invalid; I-DT labels a
    # video without fixsac
    carl = ours.frames["Carl_Snack"]
    assert len(carl) == VIDEOS["Carl_Snack"] and not any(r.gaze_valid for r in carl)
    assert [r.gaze_valid for r in ours.frames["Alice_Pizza"]].count(False) == 3
    assert any(r.fixation == 1.0 for r in ours.frames["Bob_Burger"])
    # flow images of both layouts were found
    assert ours.frames["Alice_Salad"][1].flow_xy_paths[0].endswith("flow_x_000001.jpg")
    assert ours.frames["Carl_Snack"][2].flow_path.endswith("000002.jpg")
    assert ours.frames["Alice_Pizza"][0].flow_path is None


@pytest.mark.parametrize("subject", ["Alice", "Dana"])
def test_split_matches_jax(manifests, subject):
    ours, theirs = manifests
    for a, b in zip(ours.split_leave_one_out(subject), theirs.split_leave_one_out(subject)):
        assert as_tuples(a) == as_tuples(b) and a


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=0),
    dict(batch_size=3, shuffle=True, seed=7, use_precomputed_flow=False),
    dict(batch_size=5, shuffle=False, drop_remainder=False, use_precomputed_flow=True),
])
def test_pair_batches_match_jax(manifests, kw):
    """Same pairs, same shuffle order (``default_rng(seed)``), the tail
    kept or dropped, mixed flow layouts decoded, gaze scaled to the
    model grid."""
    ours, theirs = manifests
    got = gtea.pair_batches(records(ours), target_hw=(32, 32), **kw)
    want = jgtea.pair_batches(records(theirs), target_hw=(32, 32), **kw)
    assert_batches_equal(got, want)


def test_pair_batches_auto_flow_and_a_missing_flow(manifests):
    ours, theirs = manifests
    b = next(gtea.pair_batches(records(ours), 4, (32, 32)))
    assert b["flow_img"].shape == (4,) + HW + (2,)   # every record has one: auto takes them
    # strip one video's flow: auto leaves them out, "on" raises
    recs = [dataclasses.replace(r, flow_path=None, flow_xy_paths=None)
            if r.video == "Bob_Burger" else r for r in records(ours)]
    assert "flow_img" not in next(gtea.pair_batches(recs, 4, (32, 32)))
    for mod, rs in ((gtea, recs), (jgtea, records(theirs, ["Bob_Burger"]))):
        rs = [dataclasses.replace(r, flow_path=None, flow_xy_paths=None) for r in rs]
        with pytest.raises(FileNotFoundError):
            next(mod.pair_batches(rs, 2, (32, 32), use_precomputed_flow=True))


@pytest.mark.parametrize("clip_len", [2, 4])
def test_clip_batches_match_jax(manifests, clip_len):
    ours, theirs = manifests
    assert_batches_equal(gtea.clip_batches(records(ours), 2, clip_len, (32, 32), seed=5),
                         jgtea.clip_batches(records(theirs), 2, clip_len, (32, 32), seed=5))


@pytest.mark.parametrize("layout", ["packed", "xy", "mixed"])
def test_decode_flow_images_match_jax(manifests, layout):
    ours, theirs = manifests
    videos = {"packed": ["Alice_Pizza", "Carl_Snack"], "xy": ["Alice_Salad", "Bob_Burger"],
              "mixed": ["Alice_Pizza", "Bob_Burger", "Carl_Snack"]}[layout]

    def pick(m):
        # frame 0 has no flow image; interleave the videos' records
        per = [m.frames[v][1:5] for v in videos]
        return [r for group in zip(*per) for r in group]

    got = gtea._decode_flow_images(pick(ours))
    np.testing.assert_array_equal(got, jgtea._decode_flow_images(pick(theirs)))
    assert got.shape == (4 * len(videos),) + HW + (2,) and got.dtype == np.uint8


def frame_paths(root, video="Alice_Pizza"):
    d = os.path.join(root, "images", video)
    return [os.path.join(d, n) for n in sorted(os.listdir(d))]


@pytest.mark.parametrize("target_hw", [None, (13, 17), (40, 48)])
def test_decode_batch_matches_jax(root, target_hw):
    """The same libjpeg and resize code: bit for bit, one thread or
    several."""
    paths = frame_paths(root)
    assert native_io.native_available()
    got = native_io.decode_batch(paths, target_hw, threads=3)
    np.testing.assert_array_equal(got, jnative.decode_batch(paths, target_hw))
    np.testing.assert_array_equal(got, native_io.decode_batch(paths, target_hw, threads=1))
    assert native_io.jpeg_dims(paths[0]) == jnative.jpeg_dims(paths[0]) == (HW[1], HW[0])


def test_pil_route_matches_jax(root, tmp_path, monkeypatch):
    """Without the library (no g++ or no libjpeg headers) decoding goes
    through PIL, as the JAX package's does; a PNG batch (the lossless
    flow images) always does."""
    from PIL import Image

    paths = frame_paths(root)
    native = jnative.decode_batch(paths)
    monkeypatch.setattr(native_io, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not native_io.native_available() and native_io.jpeg_dims(paths[0]) is None
    got = native_io.decode_batch(paths)
    np.testing.assert_array_equal(got, jnative.decode_batch(paths))
    np.testing.assert_array_equal(got, native)   # PIL's libjpeg decodes the same
    np.testing.assert_array_equal(native_io.decode_batch(paths, (12, 16)),
                                  jnative.decode_batch(paths, (12, 16)))
    monkeypatch.undo()
    rng = np.random.default_rng(4)
    pngs = [str(tmp_path / f"{i}.png") for i in range(2)]
    for p in pngs:
        Image.fromarray(rng.integers(0, 256, HW, dtype=np.uint8), "L").save(p)
    got = native_io.decode_batch(pngs)
    np.testing.assert_array_equal(got, jnative.decode_batch(pngs))
    np.testing.assert_array_equal(got[1, ..., 0], np.asarray(Image.open(pngs[1])))


def test_decode_errors(root, tmp_path):
    with pytest.raises(ValueError):
        native_io.decode_batch([])
    with pytest.raises(IOError):
        native_io.decode_batch(frame_paths(root)[:2] + [str(tmp_path / "missing.jpg")])
    with pytest.raises(FileNotFoundError):
        gtea.build_manifest(str(tmp_path / "nope"))


def test_library_is_built_in_the_port_keyed_by_source_flags_and_cpu():
    """Built from the port's own source into the port's ``_build``,
    never from or into ``native/``; another source, flag or CPU names
    another file."""
    path = native_io.library_path()
    port = os.path.dirname(os.path.dirname(native_io.__file__))
    assert native_io.SOURCE == native_io._PKG / "csrc" / "gaze_io.cpp"
    assert str(path).startswith(os.path.join(port, "_build", "gaze_io-"))
    assert path.exists() and "native" not in path.parts
    assert native_io._host_cpu()
