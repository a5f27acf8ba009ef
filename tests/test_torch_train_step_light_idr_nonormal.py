"""The light-idr training step with the normal losses off against the JAX
package's step: `test_torch_train_step_light_idr.py`'s check (its
docstring gives the scene, draws and tolerances) in a file of its own,
so that the suite's workers run it beside that file's normal-on cases.
"""

import pytest

from test_torch_train_step_light_idr import check_light_idr_step


@pytest.mark.parametrize("detach", [True, False],
                         ids=["detached", "coupled"])
def test_train_step_light_idr_nonormal_matches_jax(tmp_path, monkeypatch,
                                                   detach):
    check_light_idr_step(tmp_path, monkeypatch, False, detach)
