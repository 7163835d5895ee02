"""Kernels K1 and K2 on the card against their plain versions, and the
port's step on the card against its CPU path.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py -p no:cacheprovider -n 0

Tolerances: the kernel and the plain version compute every alpha with the
same float32 operations (no contraction into FMAs, the same ``expf``), so
they differ only in how transmittance products and colour sums are
accumulated — sequentially per pixel in the kernel, by ``cumprod`` or in
log space in the plain versions: atol 2e-5 for K1, atol 5e-5 / rtol 1e-4
for K2 (the CPU tests' bounds against the reference).
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import tile_lists, torch_raster

from sim_a_splat_torch import entry
from sim_a_splat_torch.ops import composite, composite_sel
from sim_a_splat_torch.physics import pusht

pytestmark = pytest.mark.cuda

TS, TX = 16, 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_k1_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    K, T = 384, 6
    counts = np.asarray([K, 200, 0, 130, K, 300], np.int32)
    skip = np.asarray([1, 1, 1, 1, 1, 0], np.int32)
    pay = tile_lists(rng, range(T), counts, K, TS, TX, opaque=(4,))
    args = [torch.as_tensor(a, device=dev) for a in (pay, counts, skip)]
    before = composite.launches
    out, car = composite.composite_static(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert composite.launches == before + 1
    ref_out, ref_car = composite.composite_static_plain(*args, TS, TX, 3.0,
                                                        1e-4)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(car, ref_car, atol=2e-5, rtol=0)
    with pytest.raises(RuntimeError, match="backward"):
        composite.composite_static(args[0].requires_grad_(), *args[1:], TS, TX)


def test_k2_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    Ks, Kd, T = 256, 128, 6
    cs = np.asarray([Ks, 100, 0, 200, Ks, 150, 0], np.int32)
    spay = np.zeros((T + 1, 10, Ks), np.float32)
    spay[:T] = tile_lists(rng, range(T), cs[:T], Ks, TS, TX, opaque=(4,))
    ids = np.asarray([[0, 4, 3, T], [1, 5, 0, T]], np.int32)
    cd = np.asarray([[40, 128, 7, 0], [60, 128, 0, 0]], np.int32)
    dpay = tile_lists(rng, ids.reshape(-1), cd.reshape(-1), Kd, TS,
                      TX).reshape(2, 4, 10, Kd)
    args = [torch.as_tensor(a, device=dev) for a in (spay, dpay, ids, cs, cd)]
    before = composite_sel.launches
    out = composite_sel.composite_pair_sel(*args, TS, TX, 3.0, 1e-4)
    torch.cuda.synchronize()
    assert composite_sel.launches == before + 1
    ref = composite_sel.composite_pair_sel_plain(*args, TS, TX, 3.0, 1e-4)
    for b in range(2):
        rows = args[2][b].long()
        torch.testing.assert_close(out[b, rows], ref[b, rows], atol=5e-5,
                                   rtol=1e-4)


def test_step_on_card_matches_cpu(dev):
    leaves = entry.build_scene_numpy(256, 64, 32, seed=0, sh_degree=3)
    vec = np.asarray([[120, 200, 149, 256, 0.3], [60, 400, 180, 300, -1.0]],
                     np.float32)
    actions = np.asarray([[149, 256], [170, 290]], np.float32)
    imgs = {}
    for d in ("cpu", dev):
        g = entry.graph_from_numpy(leaves, device=d)
        prep, step, P = entry.make_step_cached_batch(
            g, 64, 64, torch_raster(), dyn_capacity=128, sel_tiles=8,
            device=d)
        states = pusht.set_state(P, torch.as_tensor(vec, device=d))
        _, imgs[str(d)], drop = step(prep(g.scene), g.scene, states,
                                     torch.as_tensor(actions, device=d))
        assert int(drop[0]) == 0
    torch.testing.assert_close(imgs["cuda"].cpu(), imgs["cpu"], atol=1e-4,
                               rtol=0)
