"""The port's live viewer (``io/live_viewer.py``) on the cases of
``tests/test_live_viewer.py`` (scene long-polling and versions, the page,
the annotated-frame PNG, the landmark cap), and its ``/scene`` against the
JAX package's viewer serving the same map, carried across with ``convert``.

Tolerances: HTTP codes, versions, counts, ids and edges exact; coordinates
within 1e-6.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.io.live_viewer import LiveViewer as JLiveViewer
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.io.live_viewer import LiveViewer, host_copy
from ccm_slam_tpu_torch.runtime.frame import Frame
from ccm_slam_tpu_torch.solvers.reproj import level_sigma2
from tests.test_map_store import add_kf, add_mps, fresh


def jax_map(n_kf=4, n_mp=6):
    m = fresh()
    m, _ = add_mps(m, n_mp)
    a = jnp.full((16,), -1, jnp.int32)
    for i in range(n_kf):
        m, _ = add_kf(m, i, mp_assoc=a.at[0].set(i % n_mp).at[1].set((i + 1) % n_mp),
                      t=jnp.asarray([0.1 * i, -0.05 * i, 0.02]))
    return m


@pytest.fixture(scope="module")
def maps():
    jm = jax_map()
    return jm, convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:  # 4xx still carries a response
        return e.code, e.headers.get("Content-Type", ""), e.read()


def test_scene_stream_and_page(maps):
    v = LiveViewer(port=0)
    try:
        base = v.url
        code, ctype, body = _get(base)
        assert code == 200 and "text/html" in ctype
        assert b"canvas" in body

        # no scene yet: a non-blocking poll answers 204
        code, _, body = _get(base + "scene?since=-1&timeout=0.05")
        assert code == 204
        code, _, _ = _get(base + "scene?since=x")
        assert code == 400

        ver = v.publish_map(maps[1], covis_min_weight=1)
        assert ver == 1
        code, ctype, body = _get(base + "scene?since=-1")
        assert code == 200 and "json" in ctype
        j = json.loads(body)
        assert j["version"] == 1
        sc = j["scene"]
        assert sc["n_keyframes"] == 4 and sc["n_landmarks"] == 6
        assert len(sc["landmarks"]["pos"]) == 6
        assert len(sc["covisibility_edges"]) >= 1

        # long-poll: a request waiting for version > 1 unblocks on publish
        out = {}

        def poll():
            out["resp"] = _get(base + "scene?since=1&timeout=8")

        th = threading.Thread(target=poll)
        th.start()
        v.publish_map(maps[1], covis_min_weight=1)
        th.join(timeout=10)
        assert not th.is_alive()
        code, _, body = out["resp"]
        assert code == 200 and json.loads(body)["version"] == 2
        code, _, _ = _get(base + "nowhere")
        assert code == 404
    finally:
        v.close()


def test_frame_png():
    v = LiveViewer(port=0)
    try:
        code, _, _ = _get(v.url + "frame.png")
        assert code == 404
        N = 4
        octave = torch.zeros(N, dtype=torch.int32)
        f = Frame(
            timestamp=torch.tensor(0.0),
            xy=torch.tensor([[10, 10], [40, 30], [0, 0], [0, 0]], dtype=torch.float32),
            desc=torch.zeros(N, 32, dtype=torch.uint8), octave=octave,
            angle=torch.zeros(N), sigma2=level_sigma2(octave),
            valid=torch.tensor([True, True, False, False]),
            R_cw=torch.eye(3), t_cw=torch.zeros(3),
            mp=torch.tensor([3, -1, -1, -1], dtype=torch.int32),
        )
        v.publish_frame(np.full((60, 80), 90.0, np.float32), f)
        code, ctype, body = _get(v.url + "frame.png")
        assert code == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        from io import BytesIO

        from PIL import Image

        rgb = np.asarray(Image.open(BytesIO(body)))
        assert rgb.shape == (60, 80, 3)
        assert tuple(rgb[10, 10]) == (0, 220, 0)  # matched: a filled green disc
    finally:
        v.close()


def test_landmark_subsample_cap(maps):
    jm = fresh()
    jm, _ = add_mps(jm, 6)
    jm, _ = add_kf(jm, 0, mp_assoc=jnp.full((16,), -1, jnp.int32).at[0].set(0))
    m = convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")
    v = LiveViewer(port=0)
    try:
        v.publish_map(m, covis_min_weight=1, max_landmarks=3)
        _, _, body = _get(v.url + "scene?since=-1")
        sc = json.loads(body)["scene"]
        assert len(sc["landmarks"]["pos"]) <= 3
        assert sc["n_landmarks"] == 6  # counters report the true total
    finally:
        v.close()


def assert_json_close(a, b, path="scene"):
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_json_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_json_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-6, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("max_landmarks", [20000, 4])
def test_scene_matches_jax_viewer(maps, max_landmarks):
    jm, m = maps
    ours, ref = LiveViewer(port=0), JLiveViewer(port=0)
    try:
        assert ours.publish_map(host_copy(m), covis_min_weight=1,
                                max_landmarks=max_landmarks) == 1
        assert ref.publish_map(jm, covis_min_weight=1, max_landmarks=max_landmarks) == 1
        _, _, a = _get(ours.url + "scene?since=0")
        _, _, b = _get(ref.url + "scene?since=0")
        a, b = json.loads(a), json.loads(b)
        assert a["version"] == b["version"] == 1
        assert_json_close(a["scene"], b["scene"])
        # 6 landmarks, or every ceil(6 / 4) = 2nd of them
        assert len(a["scene"]["landmarks"]["pos"]) == {20000: 6, 4: 3}[max_landmarks]
    finally:
        ours.close()
        ref.close()


def test_host_copy_is_unaffected_by_later_updates(maps):
    m = convert.map_state_from_numpy(convert.map_state_fields(maps[0]), "cpu")
    snap = host_copy(m)
    before = snap.mps.pos.clone()
    m.mps.pos.add_(1.0)  # an in-place update of the live map
    assert torch.equal(snap.mps.pos, before)
    assert snap.mps.pos.data_ptr() != m.mps.pos.data_ptr()
    assert int(snap.next_kf) == int(m.next_kf)
