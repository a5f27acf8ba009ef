"""The port's EXR writer (`i2sdf_tpu_torch/utils/exr.write_exr`) against
the JAX package's native codec (`i2sdf_tpu.native.exr_write(...,
half=False)` and `exr_read`) and the port's own reader, bit for bit:
RGB, RGBA and one-channel arrays, sizes that are and are not multiples of
the 16-line ZIP block, special values (signed zeros, infinities, NaN,
subnormals) and a block too small to deflate; the files' bytes equal to
the JAX writer's. Then `run_relight` writing the linear relit image as
`{tag}_relit.exr` (no `.npy`), read back through both readers."""

import os

import numpy as np
import pytest

from i2sdf_tpu import native as jnative
from i2sdf_tpu_torch.utils import exr

SHAPES = [(20, 24, 3), (17, 5), (33, 7, 3), (1, 1, 3), (16, 16, 4),
          (48, 31), (5, 64, 3)]


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 40.0],
                                             size=shape)).astype(np.float32)
    flat = a.reshape(-1)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-42, -3e-39],
                       np.float32)
    flat[:min(len(special), flat.size)] = special[:flat.size]
    return a


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", SHAPES)
def test_write_exr_is_the_jax_writers_bytes(tmp_path, shape):
    a = _data(shape, sum(shape))
    ours, theirs = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(ours, a)
    jnative.exr_write(theirs, a, half=False)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got, names = exr.read_exr(ours)
    want, jnames = jnative.exr_read(ours)
    np.testing.assert_array_equal(_bits(got), _bits(a))
    np.testing.assert_array_equal(_bits(np.asarray(want)), _bits(a))
    assert names == list(jnames) == (
        ["Y"] if len(shape) == 2 else ["R", "G", "B", "A"][:shape[2]])


def test_write_exr_constant_image_and_named_channels(tmp_path):
    """A constant image deflates far below its raw size; channel names
    given out of order are stored sorted and read back in canonical
    order."""
    a = np.full((40, 30, 3), 0.25, np.float32)
    exr.write_exr(str(tmp_path / "c.exr"), a)
    assert os.path.getsize(tmp_path / "c.exr") < a.nbytes // 10
    got, _ = exr.read_exr(str(tmp_path / "c.exr"))
    np.testing.assert_array_equal(got, a)
    b = _data((19, 9, 3), 4)
    exr.write_exr(str(tmp_path / "n.exr"), b, names=["B", "G", "R"])
    jnative.exr_write(str(tmp_path / "nj.exr"), b, names=["B", "G", "R"],
                      half=False)
    with open(tmp_path / "n.exr", "rb") as f, open(tmp_path / "nj.exr",
                                                   "rb") as g:
        assert f.read() == g.read()
    got, names = exr.read_exr(str(tmp_path / "n.exr"))
    assert names == ["R", "G", "B"]
    np.testing.assert_array_equal(_bits(got), _bits(b[:, :, ::-1]))


def test_write_exr_fails_loudly(tmp_path):
    with pytest.raises(FileNotFoundError):
        exr.write_exr(str(tmp_path / "no" / "dir.exr"),
                      np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError):
        exr.write_exr(str(tmp_path / "empty.exr"),
                      np.zeros((0, 2, 3), np.float32))


def test_run_relight_writes_the_relit_exr(tmp_path):
    """The relit linear image is `{tag}_relit.exr`, and both readers give
    back the image `run_relight` shaded (its mean)."""
    from i2sdf_tpu_torch.config import CfgNode as TNode
    from i2sdf_tpu_torch.eval import relight as trel
    from i2sdf_tpu.data import generate_synthetic_scene
    from test_torch_relight_cli import CONF, EMITTER_SCALE, light_pair

    generate_synthetic_scene(str(tmp_path / "scene" / "demo"), n_images=2,
                             img_res=(20, 24))
    _, _, model, _ = light_pair(str(tmp_path))
    res = trel.run_relight(model, TNode(CONF), str(tmp_path / "exp"),
                           data_root=str(tmp_path / "scene"), indices=[1],
                           spp=2, chunk=256, vis_steps=4, fused=False,
                           emitter_scale=EMITTER_SCALE)
    out = res["out_dir"]
    assert sorted(os.listdir(out)) == [
        "0001_diffuse.png", "0001_relit.exr", "0001_relit.png",
        "0001_specular.png"]
    got, names = exr.read_exr(os.path.join(out, "0001_relit.exr"))
    want, _ = jnative.exr_read(os.path.join(out, "0001_relit.exr"))
    assert names == ["R", "G", "B"] and got.shape == (20, 24, 3)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))
    assert np.isfinite(got).all() and (got >= 0).all()
    assert float(got.mean()) == pytest.approx(
        res["images"][0]["mean_radiance"], rel=1e-5)
