"""The port's asset lookup against the JAX package's, and the catalog's
refusal of an asset whose loader is not ported.

``utils/image_io.reference_asset`` searches ``$CRT_ASSETS``, the reference
snapshot's mount, then ``assets`` under the working directory, as
``cpu_ray_tracing_implementation_tpu/utils/image_io.py:78-85`` does; where
it finds ``Sponza/glTF/Sponza.gltf`` the JAX package would load the glTF,
so the port's ``catalog.sponza`` raises (ROADMAP M13) before it builds
the colonnade.
"""

import pytest

from cpu_ray_tracing_implementation_tpu.utils import image_io as jio
from cpu_ray_tracing_implementation_tpu_torch.models import catalog
from cpu_ray_tracing_implementation_tpu_torch.utils import image_io

GLTF = "Sponza/glTF/Sponza.gltf"


def _write_asset(root):
    path = root / GLTF
    path.parent.mkdir(parents=True)
    path.write_text("")
    return path


@pytest.mark.parametrize("where", ["crt_assets", "working_directory", "nowhere"])
def test_reference_asset_matches_jax(tmp_path, monkeypatch, where):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CRT_ASSETS", raising=False)
    if where == "crt_assets":
        _write_asset(tmp_path / "elsewhere")
        monkeypatch.setenv("CRT_ASSETS", str(tmp_path / "elsewhere"))
    elif where == "working_directory":
        _write_asset(tmp_path / "assets")
    got = image_io.reference_asset(GLTF)
    assert got == jio.reference_asset(GLTF)
    if where != "nowhere":   # else wherever the snapshot's mount holds it
        assert got == {"crt_assets": str(tmp_path / "elsewhere" / GLTF),
                       "working_directory": "assets/" + GLTF}[where]


def test_sponza_refuses_a_present_gltf(tmp_path, monkeypatch):
    """With the asset under $CRT_ASSETS, where the JAX package would load
    it, the port raises naming M13 instead of rendering the colonnade."""
    path = _write_asset(tmp_path)
    monkeypatch.setenv("CRT_ASSETS", str(tmp_path))
    with pytest.raises(NotImplementedError, match="M13") as err:
        catalog.sponza(width=16, spp=1, max_depth=1, device="cpu")
    assert str(path) in str(err.value)
