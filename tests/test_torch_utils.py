"""The port's utils (``sim_a_splat_torch/utils``) against the reference's:
the config JSON read both ways, episodes written by one package and read
by the other, the checkpoint round trip, the tracer and ``time_jitted``."""

import json

import numpy as np
import pytest
import torch

from sim_a_splat_tpu import utils as jutils

from sim_a_splat_torch import utils
from sim_a_splat_torch.ops.rasterize_tiles import RasterConfig


def _config(mod):
    return mod.ExperimentConfig(
        cameras={0: mod.CameraConfig(type="viewport", render_size=(240, 320)),
                 1: mod.CameraConfig(type="moving", link_name="link6",
                                     local_frame_t=(0.0, 0.0, -0.3))},
        robot=mod.RobotConfig(package_name="pusharm6", num_dof=6,
                              weld_t=(0.1, 0.0, 0.0)),
        raster=mod.RasterSettings(tile_capacity=512, sigma_cutoff=None),
        seed=7,
    )


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_config_json_both_ways(tmp_path, writer):
    """A config saved by either package loads in both to the same fields,
    and the files are the same text."""
    (_config(utils) if writer == "port" else _config(jutils)).save(
        tmp_path / "cfg.json")
    mine = utils.ExperimentConfig.load(tmp_path / "cfg.json")
    ref = jutils.ExperimentConfig.load(tmp_path / "cfg.json")
    assert json.dumps(dataclass_dict(mine)) == json.dumps(dataclass_dict(ref))
    assert mine.cameras[1].link_name == "link6"
    assert mine.robot.weld_t == (0.1, 0.0, 0.0)
    assert mine.raster.tile_capacity == 512
    _config(utils).save(tmp_path / "port.json")
    _config(jutils).save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()


def dataclass_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def test_raster_settings_to_the_ports_config():
    rc = utils.RasterSettings(tile_capacity=512, chunk=32).to_raster_config()
    assert rc == RasterConfig(tile_size=16, tile_capacity=512,
                              max_tiles_per_gaussian=16, chunk=32,
                              sigma_cutoff=3.0)
    ref = jutils.RasterSettings(tile_capacity=512,
                                chunk=32).to_raster_config()
    for f in RasterConfig._fields:
        if hasattr(ref, f):
            assert getattr(rc, f) == getattr(ref, f), f


def _record(mod, out_dir, as_tensor):
    rec = mod.EpisodeRecorder(out_dir)
    wrap = torch.as_tensor if as_tensor else np.asarray
    for t in range(5):
        rec.add_step(obs={"image": wrap(np.zeros((3, 8, 8), np.float32) + t),
                          "agent_pos": wrap(np.asarray([t, 0.0],
                                                       np.float32))},
                     action=wrap(np.asarray([1.0, 2.0], np.float32)),
                     reward=float(t))
    p0 = rec.end_episode(seed=3)
    rec.add_step(obs={"image": wrap(np.ones((3, 8, 8), np.float32)),
                      "agent_pos": wrap(np.zeros(2, np.float32))},
                 action=wrap(np.zeros(2, np.float32)), reward=0.0)
    p1 = rec.end_episode()
    return p0, p1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_episodes_load_in_both(tmp_path, writer):
    """Episodes written by one package (the port from tensors) load in both,
    member by member, with the same index."""
    mod, as_tensor = (utils, True) if writer == "port" else (jutils, False)
    p0, p1 = _record(mod, tmp_path / writer, as_tensor)
    for loader in (utils.EpisodeRecorder.load_episode,
                   jutils.EpisodeRecorder.load_episode):
        ep = loader(p0)
        assert ep["obs"]["image"].shape == (5, 3, 8, 8)
        assert ep["obs"]["image"].dtype == np.float32
        np.testing.assert_array_equal(ep["obs"]["image"][:, 0, 0, 0],
                                      np.arange(5.0))
        assert ep["action"].shape == (5, 2)
        np.testing.assert_allclose(ep["reward"], np.arange(5.0))
        assert loader(p1)["obs"]["agent_pos"].shape == (1, 2)
    idx = json.loads((tmp_path / writer / "index.json").read_text())
    assert [i["length"] for i in idx] == [5, 1] and idx[0]["seed"] == 3
    assert [i["file"] for i in idx] == ["episode_000000.npz",
                                        "episode_000001.npz"]


def test_episode_files_are_the_same(tmp_path):
    """Both packages' recorders, through the same native writer, write the
    same bytes for the same steps."""
    from sim_a_splat_tpu import native as jnative
    from sim_a_splat_torch import native
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain on this host")
    a = _record(utils, tmp_path / "port", True)
    b = _record(jutils, tmp_path / "ref", False)
    for pa, pb in zip(a, b):
        assert pa.read_bytes() == pb.read_bytes()
    assert (tmp_path / "port" / "index.json").read_text() == \
        (tmp_path / "ref" / "index.json").read_text()


def test_checkpoint_roundtrip(tmp_path):
    from sim_a_splat_torch.physics import pusht
    st = pusht.reset(pusht.PushTParams(), torch.Generator().manual_seed(0), 3)
    tree = {"scene": {"means": torch.arange(12.0).reshape(4, 3)},
            "step": torch.tensor(7), "state": st, "lr": 0.5}
    utils.save_checkpoint(tmp_path / "ckpt.pt", tree)
    like = {"scene": {"means": torch.zeros(4, 3)},
            "step": torch.tensor(0), "state": pusht.PushTState(
                *(torch.zeros_like(f) for f in st)), "lr": 0.0}
    back = utils.restore_checkpoint(tmp_path / "ckpt.pt", like)
    torch.testing.assert_close(back["scene"]["means"],
                               tree["scene"]["means"], rtol=0, atol=0)
    assert int(back["step"]) == 7 and back["lr"] == 0.5
    assert isinstance(back["state"], pusht.PushTState)
    for a, b in zip(back["state"], st):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        utils.restore_checkpoint(tmp_path / "ckpt.pt",
                                 {"scene": {"means": torch.zeros(2, 3)},
                                  "step": torch.tensor(0), "state": like[
                                      "state"], "lr": 0.0})


def test_timer_and_time_jitted():
    """The tracer in the place of the reference's ``Timer``: a section's
    seconds and calls by name under its root span; then ``time_jitted``."""
    from sim_a_splat_torch.utils import profiling
    was = profiling.enabled()
    profiling.enable(True)
    try:
        x = torch.ones((64, 64))
        with profiling.span("timed"):
            with profiling.span("matmul"):
                y = x @ x
        root = profiling.roots("timed", last=1)[0]
    finally:
        profiling.enable(was)
        profiling.clear()
    assert root.calls == {"matmul": 1}
    assert 0 < root.by_name["matmul"] <= root.seconds
    mean_s, out = utils.time_jitted(lambda a: a @ a, x, iters=3, name=None)
    assert mean_s > 0 and out.shape == (64, 64)
    torch.testing.assert_close(out, y)
    lines = []
    utils.time_jitted(lambda a: a + 1, x, iters=2, name="add", log=lines.append)
    assert lines and lines[0].startswith("add: ")


def test_device_trace_writes_a_trace(tmp_path):
    with utils.device_trace(tmp_path / "trace"):
        torch.ones(8) @ torch.ones(8)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert data["traceEvents"]
