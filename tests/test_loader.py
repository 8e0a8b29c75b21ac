"""OBJ loader tests mirroring obj.rs:147-185 error paths + structure checks."""
import numpy as np
import pytest

from conftest import reference_path
from solstrale import NopTransformer
from solstrale.scene.loader import Obj

OBJ_DIR = reference_path("resources/obj") + "/"


def test_missing_file():
    with pytest.raises(FileNotFoundError,
                       match="failed to load obj model from"):
        Obj(OBJ_DIR, "missing.obj").load(NopTransformer())


def test_missing_material_file():
    with pytest.raises(FileNotFoundError, match="failed to load MTL file for"):
        Obj(OBJ_DIR, "missingMaterialLib.obj").load(NopTransformer())


def test_missing_image_file():
    with pytest.raises(FileNotFoundError,
                       match="Failed to open image texture"):
        Obj(OBJ_DIR, "missingImage.obj").load(NopTransformer())


def test_invalid_image_file():
    with pytest.raises(ValueError, match="Failed to decode image texture"):
        Obj(OBJ_DIR, "invalidImage.obj").load(NopTransformer())


def _tri_count(group):
    from solstrale.scene import TriangleMesh

    return sum(len(c) if isinstance(c, TriangleMesh) else 1
               for c in group.children)


def _materials(group):
    return {id(c.material): c.material for c in group.children}


def test_box_structure():
    group = Obj(OBJ_DIR, "box.obj").load(NopTransformer())
    assert _tri_count(group) == 12  # cube = 12 triangles


def test_box_with_mtl_diffuse():
    group = Obj(OBJ_DIR, "boxWithMat.obj").load(NopTransformer())
    # single blue diffuse material from MTL (Kd 0 0 1)
    colors = [m.albedo.rgb for m in _materials(group).values()
              if hasattr(m.albedo, "rgb")]
    assert any(np.allclose(c, [0, 0, 1]) for c in colors)


def test_normal_map_obj():
    group = Obj(OBJ_DIR, "triWithNormalMap.obj").load(NopTransformer())
    assert _tri_count(group) == 1
    mats = list(_materials(group).values())
    assert any(m.normal is not None for m in mats)


def test_spider_loads():
    group = Obj(reference_path("resources/spider") + "/", "spider.obj") \
        .load(NopTransformer())
    assert _tri_count(group) == 1368
    # four of the five MTL materials are referenced by faces
    assert len(_materials(group)) == 4


def test_native_and_python_loaders_agree():
    """The C++ fast path and the pure-Python parser produce identical
    triangle soups."""
    from solstrale import native
    from solstrale.scene import TriangleMesh
    from solstrale.scene.loader import _parse_obj

    if native.load() is None:
        import pytest

        pytest.skip("native library unavailable")

    path = reference_path("resources/spider") + "/spider.obj"
    verts, uvs, tri_mat, mat_names, mtllibs, has_uvs = native.parse_obj(path)
    positions, texcoords, faces, mtllibs_py = _parse_obj(path)
    n_py = sum(len(f[0]) - 2 for f in faces)
    assert verts.shape[0] == n_py
    assert mtllibs == mtllibs_py
    # spot-check first triangle vertices
    f0 = faces[0][0]
    np.testing.assert_allclose(verts[0, 0], positions[f0[0]], rtol=1e-6)
