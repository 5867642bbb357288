"""The port's chord compaction (ops/kernels/chords.py) against the JAX
package's, on the CPU.

`compact_chords_plain` must equal, bit for bit, JAX's Pallas
`compact_chords` (interpreted off-TPU, as tests/test_chords_kernel.py runs
it) and JAX's monolithic one-hot compaction (nerfmeshes_tpu/buff/tree.py:
316-393, written out below from JAX's own `_slab_test`), and above
`_SLAB_V` voxels JAX's slab scan `_chords_by_slab`. The cases are those of
tests/test_chords_kernel.py:61-154, plus caps that are not multiples of 8
(JAX's kernel takes only those; the port's takes any K >= 1) and V = 4096
(past JAX's 2048-voxel slab bound). ids compare as values: JAX carries
them as f32, the port as int32. The CUDA kernel itself runs only on a
card: tests/test_torch_buff_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfmeshes_tpu.buff import tree as j_tree
from nerfmeshes_tpu.ops.pallas import chords as j_chords
from nerfmeshes_tpu_torch.ops.kernels import chords as tc

torch.set_num_threads(1)


def grid_voxels(n, lo=-1.0, hi=1.0):
    """Disjoint n^3 cell partition of [lo, hi]^3 (tests/test_chords_kernel.py:20)."""
    edges = np.linspace(lo, hi, n + 1, dtype=np.float32)
    return np.array([[[edges[i], edges[j], edges[k]], [edges[i + 1], edges[j + 1], edges[k + 1]]]
                     for i in range(n) for j in range(n) for k in range(n)], np.float32)


def make_rays(rng, R, src=(0.0, 0.0, -3.0)):
    origins = np.tile(np.asarray(src, np.float32), (R, 1))
    d = rng.uniform(-0.9, 0.9, (R, 3)).astype(np.float32) - np.asarray(src, np.float32)
    return origins, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def case(name):
    """(voxels, active, origins, dirs, near, far, K) of a named case."""
    if name == "monolithic":  # test_chords_kernel.py:61
        vox = grid_voxels(3)
        o, d = make_rays(np.random.default_rng(0), 37)
        return vox, np.ones(len(vox), bool), o, d, 0.1, 10.0, 16
    if name == "per_ray_bounds":  # :89
        rng = np.random.default_rng(2)
        vox = grid_voxels(3)
        o, d = make_rays(rng, 21)
        near = rng.uniform(0.05, 2.2, 21).astype(np.float32)
        far = near + rng.uniform(1.0, 8.0, 21).astype(np.float32)
        return vox, np.ones(len(vox), bool), o, d, near, far, 8
    if name == "cap_binding":  # :101
        vox = grid_voxels(12)
        o, d = make_rays(np.random.default_rng(3), 16)
        return vox, np.ones(len(vox), bool), o, d, 0.1, 10.0, 8
    if name == "inactive":  # :115
        rng = np.random.default_rng(4)
        vox = grid_voxels(3)
        act = rng.uniform(size=len(vox)) > 0.5
        o, d = make_rays(rng, 23)
        return vox, act, o, d, 0.1, 10.0, 16
    if name == "axis_aligned":  # :129
        o = np.array([[-3.0, 0.1, 0.2], [0.1, -3.0, -0.2], [0.3, -0.1, -3.0]], np.float32)
        d = np.eye(3, dtype=np.float32)
        vox = grid_voxels(3)
        return vox, np.ones(len(vox), bool), o, d, 0.1, 10.0, 8
    if name == "axis_aligned_on_faces":  # lo == o on a zero-direction axis: NaN slab values
        o = np.array([[-3.0, -1.0 / 3.0, 0.2], [1.0 / 3.0, -3.0, -1.0], [0.0, 0.0, -3.0]],
                     np.float32)
        d = np.eye(3, dtype=np.float32)
        vox = grid_voxels(3)
        return vox, np.ones(len(vox), bool), o, d, 0.1, 10.0, 8
    if name == "miss":  # :145
        return (grid_voxels(1), np.ones(1, bool), np.array([[0.0, 0.0, -3.0]], np.float32),
                np.array([[0.0, 1.0, 0.0]], np.float32), 0.1, 10.0, 8)
    if name.startswith("k"):  # caps that are not multiples of 8, binding on a 6^3 grid
        vox = grid_voxels(6)
        o, d = make_rays(np.random.default_rng(7), 19)
        return vox, np.ones(len(vox), bool), o, d, 0.1, 10.0, int(name[1:])
    if name == "v4096":  # past JAX's _SLAB_V = 2048: its slab scan, and the kernel
        rng = np.random.default_rng(8)
        vox = grid_voxels(16)
        act = rng.uniform(size=len(vox)) > 0.3
        o, d = make_rays(rng, 64)
        return vox, act, o, d, 0.1, 10.0, 64
    raise KeyError(name)


CASES = ["monolithic", "per_ray_bounds", "cap_binding", "inactive", "axis_aligned",
         "axis_aligned_on_faces", "miss", "k1", "k7", "k12", "v4096"]
KERNEL_CASES = [c for c in CASES if c not in ("k1", "k7", "k12")]  # K % 8 == 0


def jax_monolithic(voxels, active, origins, dirs, near, far, K):
    """JAX's monolithic one-hot compaction, nerfmeshes_tpu/buff/tree.py:
    294-301, 316-319 and 373-393, on its own _slab_test."""
    R = dirs.shape[0]
    origins = jnp.broadcast_to(jnp.reshape(origins, (-1, 3)), (R, 3))
    inv_d = 1.0 / dirs
    near_r, far_r = jnp.asarray(near), jnp.asarray(far)
    near = near_r[:, None] if near_r.ndim > 0 else near_r
    far = far_r[:, None] if far_r.ndim > 0 else far_r
    mask, tmin, tmax = j_tree._slab_test(voxels, active, origins, inv_d, inv_d < 0.0, near, far)
    n_hit = jnp.sum(mask, axis=-1)
    V = voxels.shape[0]
    big = jnp.asarray(2.0 * j_tree._PAD_HI, jnp.float32)
    valid = mask.astype(jnp.int32)
    slots = jnp.where(mask, jnp.cumsum(valid, axis=-1) - 1, K)
    onehot = jax.nn.one_hot(slots, K + 1, dtype=jnp.float32)[..., :K]
    hp = jax.lax.Precision.HIGHEST
    lo_k = jnp.einsum("rv,rvk->rk", jnp.where(mask, tmin, 0.0), onehot, precision=hp)
    hi_k = jnp.einsum("rv,rvk->rk", jnp.where(mask, tmax, 0.0), onehot, precision=hp)
    ids_k = jnp.einsum("rv,rvk->rk",
                       jnp.where(mask, jnp.arange(V, dtype=jnp.float32)[None, :], 0.0),
                       onehot, precision=hp)
    in_use = jnp.arange(K)[None, :] < jnp.sum(valid, axis=-1, keepdims=True)
    return jnp.where(in_use, lo_k, big), jnp.where(in_use, hi_k, big), ids_k, n_hit


def jax_slab_scan(voxels, active, origins, dirs, near, far, K):
    """JAX's slab scan (tree.py:457-532), the path above _SLAB_V voxels."""
    R = dirs.shape[0]
    origins = jnp.broadcast_to(jnp.reshape(origins, (-1, 3)), (R, 3))
    inv_d = 1.0 / dirs
    near_r, far_r = jnp.asarray(near), jnp.asarray(far)
    near = near_r[:, None] if near_r.ndim > 0 else near_r
    far = far_r[:, None] if far_r.ndim > 0 else far_r
    return j_tree._chords_by_slab(voxels, active, origins, inv_d, inv_d < 0.0, near, far, K)


def assert_same(got, want, what):
    for name, g, w in zip(("lo_k", "hi_k", "ids_k", "n_hit"), got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"{what}: {name}")


def port(args):
    vox, act, o, d, near, far, K = args
    t = (lambda x: torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x)
    before = tc.launches
    out = tc.compact_chords(t(vox), t(act), t(o), t(d), t(near), t(far), K=K)
    assert tc.launches == before, "CPU tensors must never launch the kernel"
    return out


def jax_args(args):
    vox, act, o, d, near, far, K = args
    j = (lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x)
    return (j(vox), j(act), j(o), j(d), j(near), j(far)), K


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_monolithic(name):
    args = case(name)
    jargs, K = jax_args(args)
    assert_same(port(args), jax_monolithic(*jargs, K), "monolithic")


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_plain_matches_jax_kernel(name):
    """JAX's Pallas kernel, interpreted on the CPU (its K must be a
    multiple of 8)."""
    args = case(name)
    jargs, K = jax_args(args)
    assert_same(port(args), j_chords.compact_chords(*jargs, K=K), "pallas")


@pytest.mark.parametrize("name,slab_v", [("v4096", None), ("cap_binding", 256),
                                         ("per_ray_bounds", 8)])
def test_plain_matches_jax_slab_scan(name, slab_v, monkeypatch):
    """V = 4096 is past JAX's own 2048-voxel slab bound; smaller cases run
    the scan with the bound shrunk (tests/test_chords_kernel.py:72)."""
    if slab_v is not None:
        monkeypatch.setattr(j_tree, "_SLAB_V", slab_v)
    args = case(name)
    jargs, K = jax_args(args)
    assert args[0].shape[0] > j_tree._SLAB_V
    assert_same(port(args), jax_slab_scan(*jargs, K), "slab scan")


def test_contract_of_the_outputs():
    """Empty slots big / big / 0, chords in voxel order, n_hit counting the
    chords past K (tests/test_chords_kernel.py:211)."""
    vox, act, o, d, near, far, K = case("cap_binding")
    out = port((vox, act, o, d, near, far, K))
    assert out.lo_k.dtype == out.hi_k.dtype == torch.float32
    assert out.ids_k.dtype == out.n_hit.dtype == torch.int32
    n_valid = torch.clamp(out.n_hit, max=K)
    empty = torch.arange(K)[None, :] >= n_valid[:, None]
    assert bool((out.lo_k[empty] == tc.BIG).all() and (out.hi_k[empty] == tc.BIG).all())
    assert bool((out.ids_k[empty] == 0).all())
    assert bool((out.hi_k[~empty] >= out.lo_k[~empty]).all())
    for ids, n in zip(out.ids_k.tolist(), n_valid.tolist()):
        assert ids[:n] == sorted(set(ids[:n]))  # first chords in voxel order
    assert int((out.n_hit > K).sum()) > 0  # the cap binds in this case
    # One origin for all rays, scalar bounds as 0-dim tensors: the same.
    again = tc.compact_chords_plain(torch.from_numpy(vox), torch.from_numpy(act),
                                    torch.from_numpy(o[0]), torch.from_numpy(d),
                                    torch.tensor(near), torch.tensor(far), K=K)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_dispatch_never_falls_back():
    vox, act, o, d, near, far, K = case("monolithic")
    t = [torch.from_numpy(x) for x in (vox, act, o, d)]
    with pytest.raises(ValueError, match="CUDA"):
        tc.compact_chords_cuda(*t, near, far, K=K)
    with pytest.raises(ValueError, match="no chord compaction"):
        tc.compact_chords(*(x.to("meta") for x in t), near, far, K=K)
    with pytest.raises(ValueError, match="on meta"):
        tc.compact_chords(t[0].to("meta"), *t[1:], near, far, K=K)
    with pytest.raises(ValueError, match="K must be"):
        tc.compact_chords(*t, near, far, K=0)
    with pytest.raises(ValueError, match="active"):
        tc.compact_chords(t[0], t[1].float(), *t[2:], near, far, K=K)
    with pytest.raises(ValueError, match="near"):
        tc.compact_chords(*t, torch.zeros(5), far, K=K)
    empty = tc.compact_chords(t[0], t[1], t[2][:0], t[3][:0], near, far, K=K)
    assert empty.lo_k.shape == (0, K) and empty.n_hit.shape == (0,)
