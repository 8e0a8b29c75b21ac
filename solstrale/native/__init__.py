"""ctypes bindings for the native C++ runtime library (OBJ ingest + LBVH
build). Built from ``solstrale_native.cpp`` by ``make`` on first use into
``build/`` beside this file (not tracked); all callers degrade to the
pure-Python/numpy implementations when the toolchain is unavailable."""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "build", "libsolstrale_native.so")
_lib = None
_tried = False


class _ObjMesh(ctypes.Structure):
    _fields_ = [
        ("tri_verts", ctypes.POINTER(ctypes.c_float)),
        ("tri_uvs", ctypes.POINTER(ctypes.c_float)),
        ("tri_mat", ctypes.POINTER(ctypes.c_int32)),
        ("n_tris", ctypes.c_int32),
        ("has_uvs", ctypes.c_int32),
        ("mat_names", ctypes.c_char_p),
        ("mtl_libs", ctypes.c_char_p),
    ]


def load():
    """Return the loaded library or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        try:
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.obj_parse.restype = ctypes.POINTER(_ObjMesh)
    lib.obj_parse.argtypes = [ctypes.c_char_p]
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjMesh)]
    lib.lbvh_sort.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.lbvh_nodes.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def parse_obj(path):
    """Native OBJ parse → (tri_verts (N,3,3), tri_uvs (N,3,2), tri_mat (N,),
    mat_names list, mtl_libs list, has_uvs) or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    mesh_p = lib.obj_parse(os.fsencode(path))
    if not mesh_p:
        return None
    m = mesh_p.contents
    n = int(m.n_tris)
    verts = np.ctypeslib.as_array(m.tri_verts, (n, 3, 3)).copy()
    uvs = np.ctypeslib.as_array(m.tri_uvs, (n, 3, 2)).copy()
    mats = np.ctypeslib.as_array(m.tri_mat, (n,)).copy()
    names = m.mat_names.decode() if m.mat_names else ""
    libs = m.mtl_libs.decode() if m.mtl_libs else ""
    has_uvs = bool(m.has_uvs)
    lib.obj_free(mesh_p)
    return (verts, uvs, mats,
            names.split("\n") if names else [],
            libs.split("\n") if libs else [], has_uvs)


def lbvh_sort(aabb_min, aabb_max):
    """Native Morton-order permutation, or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    n = mn.shape[0]
    order = np.empty(n, np.int32)
    lib.lbvh_sort(mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  n, order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return order


def lbvh_nodes(slot_min, slot_max, leaf_size):
    """Native complete-tree AABB reduction, or None if unavailable."""
    lib = load()
    if lib is None:
        return None
    mn = np.ascontiguousarray(slot_min, np.float32)
    mx = np.ascontiguousarray(slot_max, np.float32)
    n_slots = mn.shape[0]
    n_leaves = n_slots // leaf_size
    node_min = np.empty((2 * n_leaves - 1, 3), np.float32)
    node_max = np.empty((2 * n_leaves - 1, 3), np.float32)
    lib.lbvh_nodes(mn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   mx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   n_slots, leaf_size,
                   node_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                   node_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return node_min, node_max
