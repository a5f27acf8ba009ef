"""A trained material stage in the port's relight and mesh
(`--use_material`: `train/material.py::load_material_stage`,
`eval/relight.py::run_relight(material=)`, `eval/mesh.py::
run_mesh_eval(material=)`) against the JAX package's with the same stage
(converted with `params.material_to_jax`), on the CPU, on the trainer
tests' scene, model and 8-step fit (`test_torch_material_trainer.py`):
relit PNGs and linear EXR within PSNR 40 dB, means at rtol 1e-3 (the
draws JAX's own, `JaxDraws(PRNGKey(5))`); the meshes' vertices matched
by nearest neighbour in world space, 1e-4 apart on average and at most
5e-3 (under a tenth of the 32^3 grid's spacing; the two PCA frames part
in the last digits), their albedo colours within one 8-bit level."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from i2sdf_tpu.config import CfgNode as JNode
from i2sdf_tpu.eval import mesh as jmesh
from i2sdf_tpu.eval import relight as jrel
from i2sdf_tpu.models import material as jmat
from i2sdf_tpu_torch.config import CfgNode as TNode
from i2sdf_tpu_torch.eval import mesh as tmesh
from i2sdf_tpu_torch.eval import relight as trel
from i2sdf_tpu_torch.params import material_to_jax
from i2sdf_tpu_torch.train import material as ttm
from i2sdf_tpu_torch.utils import exr, imaging
from test_torch_helpers import JaxDraws
from test_torch_material_trainer import (MCONF, _ply_colors, pair,  # noqa
                                         scene, trained)

PSNR_BAR_DB = 40.0


def test_use_material_relight_and_mesh_match_jax(scene, pair, trained,
                                                 tmp_path):
    jcfg, params, model, _ = pair
    _, exp, _ = trained["straight"]
    stage, mcfg, em = ttm.load_material_stage(exp, TNode(MCONF))
    assert em.count == 1
    jtree = jax.tree_util.tree_map(jnp.asarray,
                                   material_to_jax(stage.state_dict()))
    jmcfg = jmat.MaterialNetConfig(dims=(16, 16), multires=2)
    jem = jrel.Emitters(em.centers.numpy(), em.radii.numpy(),
                        jmat.emission_apply(jtree["emission"]))
    jmaterial = (jtree, jmcfg, jem)
    kw = dict(data_root=scene, indices=[0, 1], spp=2, chunk=256,
              vis_steps=4, seed=5)
    jres = jrel.run_relight(params, jcfg, JNode(MCONF), str(tmp_path / "j"),
                            fused=False, material=jmaterial, **kw)
    tres = trel.run_relight(model, TNode(MCONF), str(tmp_path / "t"),
                            fused=False, material=(stage, mcfg, em),
                            draws=JaxDraws(jax.random.PRNGKey(5)), **kw)
    jdir, tdir = jres["out_dir"], tres["out_dir"]
    for tag in ("0000", "0001"):
        for name in ("relit", "diffuse", "specular"):
            a = imaging.read_png(os.path.join(tdir, f"{tag}_{name}.png"))
            b = imaging.read_png(os.path.join(jdir, f"{tag}_{name}.png"))
            assert imaging.psnr(a / 255.0, b / 255.0) >= PSNR_BAR_DB
        got, _ = exr.read_exr(os.path.join(tdir, f"{tag}_relit.exr"))
        want, _ = exr.read_exr(os.path.join(jdir, f"{tag}_relit.exr"))
        peak = float(np.abs(want).max())
        assert imaging.psnr(got / peak, want / peak) >= PSNR_BAR_DB
    np.testing.assert_allclose(
        [r["mean_radiance"] for r in tres["images"]],
        [r["mean_radiance"] for r in jres["images"]], rtol=1e-3)

    tply = tmesh.run_mesh_eval(model, TNode(MCONF), str(tmp_path / "t"),
                               data_root=scene, resolution=32, fused=False,
                               material=(stage, mcfg, em))
    jply = jmesh.run_mesh_eval(params, jcfg, JNode(MCONF),
                               str(tmp_path / "j"), data_root=scene,
                               resolution=32, fused=False,
                               material=jmaterial)
    tv, tc = _ply_colors(tply)
    jv, jc = _ply_colors(jply)
    assert len(tv) == len(jv) > 0
    nn = np.argmin(((tv[:, None] - jv[None]) ** 2).sum(-1), axis=1)
    d = np.linalg.norm(tv - jv[nn], axis=-1)
    assert d.mean() < 1e-4 and d.max() < 5e-3, (d.mean(), d.max())
    assert np.abs(tc - jc[nn]).max() <= 1
