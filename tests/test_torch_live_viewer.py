"""The port's copy of the live viewer (`ya_vo_tpu_torch/viz/live.py`): the
cases of tests/test_live_viewer.py on a port frontend, over localhost HTTP,
and `attach` on the port frontend's observers under both drivers."""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_frontend_e2e import make_config as e2e_config
from ya_vo_tpu_torch.config import VOConfig
from ya_vo_tpu_torch.tracking.frontend import Frontend
from ya_vo_tpu_torch.utils import synthetic
from ya_vo_tpu_torch.viz import live


def make_config():
    """test_live_viewer.py's config (sync BA) with the port's apply mode,
    as the port's own VOConfig."""
    cfg = dataclasses.asdict(e2e_config(sync_ba=True, apply_mode="push"))
    return VOConfig.from_dict(cfg)


@pytest.fixture(scope="module")
def sequence():
    return synthetic.render_sequence(
        n_frames=6, n_landmarks=400, height=256, width=768,
        step=0.4, yaw_rate=0.004, seed=7)


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read()


@pytest.mark.parametrize("pipelined", [False, True])
def test_viewer_serves_state_and_page(sequence, pipelined):
    imgs, _, _, cam = sequence
    fe = Frontend(make_config(), cam, device="cpu")
    viewer = live.attach(fe, port=0)
    try:
        assert fe.live_viewer is viewer and len(fe.observers) == 1
        fe.run(imgs, pipelined=pipelined)

        st, body = _get(viewer.port, "/state.json")
        assert st == 200
        s = json.loads(body)
        assert s["frame_id"] == 5
        assert s["status"] == "TRACKING"
        assert len(s["traj"]) == 6
        assert s["n_landmarks"] > 50
        assert len(s["landmarks"]) > 50
        assert np.asarray(s["pose"]).shape == (4, 4)
        np.testing.assert_allclose(s["pose"], fe.last_pose, atol=1e-6)
        assert s["fps"] > 0

        st, page = _get(viewer.port, "/")
        assert st == 200
        assert b"state.json" in page and b"canvas" in page

        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.port, "/nope")
        assert e.value.code == 404
    finally:
        viewer.close()


def test_viewer_survives_map_downsampling():
    """Cloud shipped per poll stays bounded on big maps."""
    v = live.LiveViewer(port=0, max_landmarks=10)

    class FakeMap:
        n_keyframes = 3

        def alive_landmarks(self):
            return np.random.default_rng(0).normal(
                size=(1000, 3)).astype(np.float32), None

        def stats(self):
            return {"n_alive": 1000}

    try:
        v.update_map(FakeMap(), n_resets=2)
        s = json.loads(v.state_json())
        assert len(s["landmarks"]) <= 10
        assert s["n_landmarks"] == 1000
        assert s["resets"] == 2
    finally:
        v.close()
