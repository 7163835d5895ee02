"""The check that decides ``correct`` fails what it has to: a run of a
small cell on the CPU, its look for a card skipped, with the timed path
broken underneath in each way the cell can be, comes out not correct; and
the control, the reference in bfloat16 in the program's place, reads past
every limit it is held to.  (One chip: no exchange between chips to leave
out.)"""

import contextlib

import pytest
import torch

from perfbench.harness import bench as harness
from perfbench.harness import trace as tr
from perfbench.tests import tiny

DATAGEN, TRAIN = tiny.CELLS


@contextlib.contextmanager
def broken(target, make):
    key = tr.resolve(target)
    with tr.patched({key: make(getattr(*key))}):
        yield


def frozen_state(control_step):
    """A step that returns its state unchanged."""
    return lambda params, state, action: state


def altered_image(render):
    """One pixel of every image off by 0.05 where the image is made."""
    def f(*args, **kw):
        imgs, aux = render(*args, **kw)
        imgs = imgs.clone()
        imgs[:, 0, 10, 10] += 0.05
        return imgs, aux
    return f


def half_batch(make_step):
    """A step whose images cover the first half of the envs only (the
    second half rendered as copies of the first): the loss is then a mean
    over half the batch."""
    def make(*args, **kw):
        prepare, step, params = make_step(*args, **kw)

        def half(cache, scene, states, actions):
            new, imgs, n_drop = step(cache, scene, states, actions)
            h = imgs.shape[0] // 2
            return new, torch.cat([imgs[:h], imgs[:h]]), n_drop
        return prepare, half, params
    return make


def altered_gradient(loss_and_grads):
    """The means' gradient off by 10 % where it is produced: some twenty
    times the widest gap sound runs read (5.1e-3 of the field's
    largest)."""
    def f(*args):
        new, loss, n_drop, grads = loss_and_grads(*args)
        return new, loss, n_drop, grads._replace(means=grads.means * 1.1)
    return f


FAULTS = {
    (DATAGEN, "state unchanged"): (
        "sim_a_splat_torch.physics.pusht:control_step", frozen_state),
    (DATAGEN, "image altered"): (
        "sim_a_splat_torch.entry:rasterize_cache_sel_batch", altered_image),
    (DATAGEN, "half the batch"): (
        "sim_a_splat_torch.entry:make_step_cached_batch", half_batch),
    (TRAIN, "state unchanged"): (
        "sim_a_splat_torch.physics.pusht:control_step", frozen_state),
    (TRAIN, "half the batch"): (
        "sim_a_splat_torch.entry:make_step_cached_batch", half_batch),
    (TRAIN, "gradient altered"): (
        "sim_a_splat_torch.entry:loss_and_grads", altered_gradient),
}


@pytest.mark.parametrize("cell,fault", list(FAULTS), ids=[
    f"{c.split('-')[1]}: {f}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    target, make = FAULTS[(cell, fault)]
    with broken(target, make):
        line = tiny.run_small(tmp_path, cell, seed=4000000007)
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed, line["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_fails_the_limits(tmp_path, cell):
    """The reference in bfloat16 put in the program's place reads past the
    limits (float32 is the configurations' precision)."""
    cdir, tdir = tiny.write_small(tmp_path)
    b = tiny.bench()
    w = harness.find_cell(b, cell)
    cfg = harness.load_config(w["config"], cdir)
    from perfbench.harness import traffic as traffic_gen
    from perfbench.systems import pusht_fixed
    mix = traffic_gen.load(w["traffic"], tdir)
    system = pusht_fixed.System(cfg, mix, 4000000011, "cpu")
    for _ in range(int(mix["check"]["before"]) + 1):
        system.step()
    system.release()
    readings = system.control(torch.bfloat16)
    over = [k for k, v in readings.items() if v > cfg["limits"][k]]
    assert set(over) == set(readings), readings
