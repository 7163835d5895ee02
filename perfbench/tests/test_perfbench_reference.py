"""The plain reference against the port's CPU path at a small size, and
the roofline counts against the rule of the port's card script."""

import importlib.util

import pytest
import torch

from perfbench.roofline import k1f, k2f, k2b, peaks
from perfbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_port_on_the_cpu_reads_as_the_reference(tmp_path, cell):
    line = tiny.run_small(tmp_path, cell)
    assert line["correct"] is True
    c = {k: v["value"] for k, v in line["checks"].items()}
    assert c["state_gap"] == 0.0 and c["bounded_gap"] == 0
    if "image_gap" in c:
        assert c["image_gap"] < 1e-5
    else:
        assert c["loss_gap"] < 1e-6 and c["grad_gap"] < 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", tiny.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(tmp_path):
    """One K1 and one K2 call's arguments from a small forward step."""
    from perfbench.harness import trace as tr
    caps = tr.Captures([k1f.CAPTURE, k2f.CAPTURE])
    caps.on = True
    with tr.patched(caps.wrappers({})):
        tiny.run_small(tmp_path, tiny.CELLS[0])
    return caps.args[k1f.CAPTURE][0], caps.args[k2f.CAPTURE][0]


def test_the_roofline_counts_follow_the_card_scripts_rule(tmp_path):
    from sim_a_splat_torch.ops import composite, composite_sel
    cs = _chip_smoke()
    a1, a2 = _captured(tmp_path)
    # K1f: the port's plain version's own work count, by chip_smoke's rule
    _, _, applied, hits = composite.composite_static_plain(*a1,
                                                           return_work=True)
    pay, counts, skip, ts = a1[:4]
    K, T, P = pay.shape[-1], counts.numel(), ts * ts
    nc = K // composite.CHUNK
    cnt = torch.where(skip > 0, counts, 0).long()
    c0 = torch.arange(nc) * composite.CHUNK
    entries = int((torch.clamp(cnt[:, None] - c0, 0, composite.CHUNK)
                   * (torch.arange(nc)[None] < applied[:, None])).sum())
    want = cs.bound(entries * 40 + T * 8 + T * P * (8 + nc) * 4,
                    cs.ALPHA_FLOPS * P * entries
                    + cs.BLEND_FLOPS * int(hits.sum()))[0]
    assert peaks.bound_s(*k1f.work(a1)) * 1e3 == pytest.approx(want,
                                                               rel=1e-12)
    # K2f and K2b
    spay, dpay, ids, cs_pad, cd = a2[:5]
    _, applied, hits = composite_sel.composite_pair_sel_plain(
        *a2, return_work=True)
    Ks, Kd, T1 = spay.shape[-1], dpay.shape[-1], spay.shape[0]
    P = a2[5] ** 2
    cs_slot = torch.clamp(cs_pad[ids.long()].long(), max=Ks)
    c0 = torch.arange(Ks // composite.CHUNK) * composite.CHUNK
    s_entries = (torch.clamp(cs_slot[..., None] - c0, 0, composite.CHUNK)
                 * (torch.arange(len(c0)) < applied[..., None])).sum(-1)
    d_entries = torch.clamp(cd.long(), max=Kd)
    entries = int(s_entries.sum() + d_entries.sum())
    tile_need = torch.zeros(T1, dtype=torch.long).scatter_reduce(
        0, ids.long().reshape(-1), s_entries.reshape(-1), "amax")
    real = ids.long() < T1 - 1
    rows = int(real.sum()) + int((~real).any(dim=1).sum())
    lists = (int(tile_need.sum()) * 40 + int(d_entries.sum()) * 40
             + ids.numel() * 8 + T1 * 4)
    want_f = cs.bound(lists + rows * 8 * P * 4,
                      cs.ALPHA_FLOPS * P * entries
                      + cs.BLEND_FLOPS * int(hits.sum()))[0]
    want_b = cs.bound(lists + rows * 2 * 5 * P * 4 + T1 * 10 * Ks * 4
                      + ids.numel() * 10 * Kd * 4,
                      cs.ALPHA_FLOPS * P * entries
                      + cs.GRAD_FLOPS * int(hits.sum()))[0]
    assert peaks.bound_s(*k2f.work(a2)) * 1e3 == pytest.approx(want_f,
                                                               rel=1e-12)
    assert peaks.bound_s(*k2b.work(a2)) * 1e3 == pytest.approx(want_b,
                                                               rel=1e-12)
    assert (peaks.PEAK_FP32_FLOPS, peaks.PEAK_BYTES_S) == (
        cs.PEAK_FP32_FLOPS, cs.PEAK_BYTES_S)
