"""The port's flow-image producer (``data/flow_extract.py``) and its parts
against the JAX package's on the CPU.

- ``quantize_flow`` and ``dequantize_flow`` bit for bit, exact halves
  included (round half to even);
- ``dense_flow_tvl1_config()`` and its pyramid at 720x960 equal;
- ``make_flow_quant_fn`` and ``extract_flow_images`` (PNG, so the codec
  adds nothing; both layouts; a padded tail window): codes at most one
  apart, on at most ``CODE_SHARE`` of them. The two TV-L1 solvers round
  multiply-adds differently (XLA contracts them into FMAs), which can
  move a flow across a quantization boundary; measured equal at these
  sizes.
- the producer decodes one window of ``batch_size`` pairs at a time and
  its output reads back through ``build_manifest``/``pair_batches``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaze_tpu.core import config as jconfig
from gaze_tpu.data import flow_extract as jfe
from gaze_tpu.ops import tvl1 as jtvl1
from gaze_tpu_torch.core import config as tconfig
from gaze_tpu_torch.data import flow_extract as tfe
from gaze_tpu_torch.data.gtea import build_manifest, pair_batches
from gaze_tpu_torch.ops import tvl1
from tests.torch_gtea_tree import texture_frames, write_tree
from tests.torch_threads import cap_torch_threads  # noqa: F401  (autouse)

HW = (24, 32)
CODE_SHARE = 1e-3
# a small dense_flow-shaped schedule: factor 0.8, a 5-wide median
SOLVER = dict(pyramid_levels=3, pyramid_factor=0.8, warps=2, iters=4, median_kernel=5)
BOUND = 2.0   # narrow, so that the codes spread over most of [0, 255]


def specs(**kw):
    return (tfe.FlowExtractSpec(tvl1=tconfig.TVL1Config(**SOLVER), bound=BOUND, **kw),
            jfe.FlowExtractSpec(tvl1=jconfig.TVL1Config(**SOLVER), bound=BOUND, **kw))


def assert_codes_close(got, want):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1 and (d > 0).mean() <= CODE_SHARE, (d.max(), (d > 0).mean())


def test_quantize_flow_matches_jax():
    rng = np.random.default_rng(0)
    k = np.arange(256)
    halves = ((k + 0.5) * (2 * 15.0 / 255) - 15.0).astype(np.float32)   # x.5 codes
    for bound, x in ((15.0, rng.uniform(-20, 20, (3, 9, 11, 2)).astype(np.float32)),
                     (15.0, halves), (2.0, rng.normal(0, 2, (50,)).astype(np.float32))):
        got = tvl1.quantize_flow(torch.from_numpy(x), bound)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtvl1.quantize_flow(x, bound)))
    q = rng.integers(0, 256, (4, 5, 2), np.uint8)
    np.testing.assert_array_equal(tvl1.dequantize_flow(torch.from_numpy(q), 15.0).numpy(),
                                  np.asarray(jtvl1.dequantize_flow(jnp.asarray(q), 15.0)))


def test_dense_flow_preset_and_its_pyramid_match_jax():
    ours, theirs = tconfig.dense_flow_tvl1_config(), jconfig.dense_flow_tvl1_config()
    assert ours == tconfig.TVL1Config(**{f: getattr(theirs, f)
                                         for f in ours.__dataclass_fields__})
    shapes = tvl1._pyramid_shapes(720, 960, ours.pyramid_levels, ours.pyramid_factor)
    assert shapes == jtvl1._pyramid_shapes(720, 960, theirs.pyramid_levels,
                                           theirs.pyramid_factor)
    assert len(shapes) == 5 and shapes[1] == (576, 768)
    assert tvl1._median_passes(ours) == 2


@pytest.mark.parametrize("flow_scale", [1.0, 0.5])
def test_quant_fn_matches_jax(flow_scale):
    frames = texture_frames(np.random.default_rng(1), 4, HW, drift=1.3)
    ours, theirs = specs(flow_scale=flow_scale)
    got = tfe.make_flow_quant_fn(ours, HW, "cpu")(frames[:-1], frames[1:])
    want = jax.jit(jfe.make_flow_quant_fn(theirs, HW))(jnp.asarray(frames[:-1]),
                                                      jnp.asarray(frames[1:]))
    assert got.dtype == torch.uint8 and len(np.unique(got.numpy())) > 64
    assert_codes_close(got.numpy(), want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("gtea"), {"Ann_Soup": 6, "Ben_Tea": 4}, HW,
                      seed=5, no_gaze=("Ben_Tea",))


def read(path):
    from PIL import Image

    return np.asarray(Image.open(path))


@pytest.mark.parametrize("layout", ["xy", "packed"])
def test_extract_flow_images_matches_jax(root, tmp_path, layout):
    """PNG files of both producers: the same names (none for frame 0),
    codes at most one apart; the windows of 3 pairs leave a padded tail
    (5 and 3 pairs)."""
    ours, theirs = specs(layout=layout, fmt="png", batch_size=3)
    n = tfe.extract_flow_images(root, ours, out_root=str(tmp_path / "ours"), verbose=False,
                                device="cpu")
    assert n == jfe.extract_flow_images(root, theirs, out_root=str(tmp_path / "theirs"),
                                        verbose=False) == 5 + 3
    for v in ("Ann_Soup", "Ben_Tea"):
        names = sorted(os.listdir(tmp_path / "ours" / v))
        assert names == sorted(os.listdir(tmp_path / "theirs" / v))
        assert not any("000000" in x for x in names)
        got = np.stack([read(tmp_path / "ours" / v / x) for x in names])
        assert_codes_close(got, np.stack([read(tmp_path / "theirs" / v / x) for x in names]))
        if layout == "packed":
            assert (got[..., 2] == 128).all()


def test_extraction_decodes_per_window_and_reads_back(root, tmp_path, monkeypatch):
    """No decode holds more than a window (batch_size + 1 frames); the
    PNG codes read back through the manifest equal the solver's."""
    sizes = []
    decode = tfe.decode_batch
    monkeypatch.setattr(tfe, "decode_batch", lambda paths: sizes.append(len(paths))
                        or decode(paths))
    spec, _ = specs(layout="xy", fmt="png", batch_size=2)
    out = tmp_path / "tree"
    out.mkdir()
    os.symlink(os.path.join(root, "images"), out / "images")
    assert tfe.extract_flow_images(str(out), spec, verbose=False, device="cpu") == 8
    assert max(sizes) <= spec.batch_size + 1
    recs = build_manifest(str(out), native_hw=HW).frames["Ann_Soup"]
    frames = decode(sorted(r.image_path for r in recs))
    want = tfe.make_flow_quant_fn(spec, HW, "cpu")(frames[:-1], frames[1:]).numpy()
    b = next(pair_batches(recs, 5, (32, 32), shuffle=False))
    np.testing.assert_array_equal(b["flow_img"], want)


def test_spec_and_device_checks(root, monkeypatch):
    with pytest.raises(ValueError):
        specs(fmt="bmp")
    with pytest.raises(ValueError):
        specs(layout="planar")
    spec, _ = specs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfe.extract_flow_images(root, spec, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfe.make_flow_quant_fn(spec, HW)
    with pytest.raises(FileNotFoundError):
        tfe.extract_flow_images(os.path.join(root, "nope"), spec, device="cpu")
