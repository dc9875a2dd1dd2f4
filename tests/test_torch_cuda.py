"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (inside the test) when no card is present.
On a machine with one:  python -m pytest tests/test_torch_cuda.py -q -n 0
"""

import pytest
import torch

from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.ops import ba_kernels as bk, hamming, hamming_kernels as hk, matching, orb
from ccm_slam_tpu_torch.solvers import ba

pytestmark = pytest.mark.cuda

DELTA = 2.447651936


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def args(prob):
    return (prob.R, prob.t, prob.X, prob.point_valid, prob.cam_idx, prob.uv,
            prob.sigma2, prob.obs_valid)


def close(ours, ref, rtol, atol_scale):
    """Sums are taken in another order on the card (CSR segments and tree
    sums): tolerance scaled by the largest entry."""
    ref = ref.detach().cpu()
    atol = atol_scale * float(ref.abs().max()) + 1e-6
    torch.testing.assert_close(ours.detach().cpu(), ref, rtol=rtol, atol=atol)


def problem(name, dev):
    if name == "bench":
        return problems.make_problem(C=128, P=4096, K=8, device=dev)
    return convert.ba_problem_from_numpy(problems.ragged_problem_arrays(), dev)


@pytest.mark.parametrize("name", ["bench", "ragged"])
def test_reproj_cost_kernel(name):
    prob = problem(name, card())
    ours = bk.reproj_cost(*args(prob), prob.intr, DELTA)
    ref = bk.reproj_cost_plain(*args(prob), prob.intr, DELTA)
    assert abs(float(ours) - float(ref)) < 1e-4 * abs(float(ref)) + 1e-2


@pytest.mark.parametrize("name", ["bench", "ragged"])
def test_normal_blocks_kernel(name):
    prob = problem(name, card())
    csr = bk.cam_csr(prob.cam_idx, prob.R.shape[0])
    ours = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    ref = bk.normal_blocks_plain(*args(prob), prob.cam_fixed, prob.intr, DELTA)
    for a, b in zip(ours[:5], ref[:5]):
        close(a, b, 5e-3, 1e-5)
    assert abs(float(ours[5]) - float(ref[5])) < 1e-4 * abs(float(ref[5])) + 1e-2


@pytest.mark.parametrize("name", ["bench", "ragged"])
def test_schur_ops_kernels(name):
    dev = card()
    prob = problem(name, dev)
    C, (P, _) = prob.R.shape[0], prob.cam_idx.shape
    csr = bk.cam_csr(prob.cam_idx, C)
    _, V, W, _, _, _ = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    Vinv = ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=dev))).contiguous()
    g = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn(C, 6, generator=g).to(dev)
    q = torch.randn(P, 3, generator=g).to(dev)
    for fk, fp, x in zip(bk.schur_ops(W, Vinv, csr),
                         bk.schur_ops_plain(W, Vinv, prob.cam_idx, C), (v, q, v)):
        close(fk(x), fp(x), 1e-4, 1e-4)


def client_problem(name, dev):
    """The client's local-BA widths (C=40 cameras, P=4096 landmarks) at K=16
    (rendered_ci_config) and K=32 (the default max_obs_per_mp), and a ragged
    K=12 case with fixed cameras, invalid points and out-of-range ids."""
    if name == "local_ba_k16":
        return problems.make_problem(C=40, P=4096, K=16, device=dev)
    if name == "local_ba_k32":
        return problems.make_problem(C=40, P=4096, K=32, device=dev)
    arr = problems.small_ba_problem_arrays(P=3001, K=12, C=37, seed=12, fixed=5)
    arr["cam_idx"][~arr["obs_valid"]] = -1  # local BA's padding: camera 0 spans many chunks
    arr["cam_idx"][:4, 0] = [-1, 37, 40, -3]
    return convert.ba_problem_from_numpy(arr, dev)


@pytest.mark.parametrize("name", ["local_ba_k16", "local_ba_k32", "ragged_k12"])
def test_normal_blocks_kernel_client_shapes(name):
    """One thread per observation, camera sums through CamCSR.order: equal
    to the plain version, fixed cameras exactly zero, bit-identical rerun."""
    prob = client_problem(name, card())
    csr = bk.cam_csr(prob.cam_idx, prob.R.shape[0])
    bk.reset_launch_counts()
    ours = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    again = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    assert bk.launch_counts()["normal_blocks"] == 2
    ref = bk.normal_blocks_plain(*args(prob), prob.cam_fixed, prob.intr, DELTA)
    for a, b in zip(ours[:5], ref[:5]):
        close(a, b, 5e-3, 1e-5)
    assert abs(float(ours[5]) - float(ref[5])) < 1e-4 * abs(float(ref[5])) + 1e-2
    fixed = prob.cam_fixed.nonzero().flatten()
    assert float(ours[0][fixed].abs().max()) == 0.0 and float(ours[3][fixed].abs().max()) == 0.0
    for x, y in zip(ours, again):
        assert torch.equal(x, y)


def test_normal_blocks_kernel_wide_landmarks():
    """K=300 slots: 512-thread point blocks of one landmark, above 48 KB of
    shared memory (the kernel's opt-in path); equal to the plain version."""
    dev = card()
    arr = problems.small_ba_problem_arrays(P=64, K=300, C=37, seed=300, fixed=3)
    prob = convert.ba_problem_from_numpy(arr, dev)
    csr = bk.cam_csr(prob.cam_idx, prob.R.shape[0])
    assert bk.point_layout(300) == (512, 1)
    ours = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    ref = bk.normal_blocks_plain(*args(prob), prob.cam_fixed, prob.intr, DELTA)
    for a, b in zip(ours[:5], ref[:5]):
        close(a, b, 5e-3, 1e-5)
    assert abs(float(ours[5]) - float(ref[5])) < 1e-4 * abs(float(ref[5])) + 1e-2


def test_cam_reduce_kernel_stress_shape():
    """E=1,048,576 rows into C=1024 cameras (the GBA stress shape), a tenth
    of the ids out of range: dropped; bit-identical on a rerun."""
    dev = card()
    g = torch.Generator(device="cpu").manual_seed(1024)
    E, C = 1048576, 1024
    y = torch.randn(E, 6, generator=g).to(dev)
    ci = torch.randint(0, C, (E,), generator=g, dtype=torch.int32)
    bad = torch.rand(E, generator=g) < 0.1
    ci[bad] = torch.where(torch.rand(E, generator=g) < 0.5, -1, C + 7)[bad].to(torch.int32)
    ci = ci.to(dev)
    csr = bk.reduce_csr(ci, C)
    ours, again = bk.cam_reduce(y, ci, C, csr), bk.cam_reduce(y, ci, C, csr)
    close(ours, bk.cam_reduce_plain(y, ci, C), 1e-4, 1e-5)
    assert torch.equal(ours, again)
    assert int(csr.offsets[C]) == E - int(bad.sum())


def test_cam_broadcast_kernel():
    dev = card()
    g = torch.Generator(device="cpu").manual_seed(1)
    v = torch.randn(37, 12, generator=g).to(dev)
    ci = torch.randint(-3, 40, (9999,), generator=g, dtype=torch.int32).to(dev)
    torch.testing.assert_close(bk.cam_broadcast(v, ci), bk.cam_broadcast_plain(v, ci),
                               rtol=0, atol=0)


@pytest.mark.parametrize("F", [5, 6, 12])
@pytest.mark.parametrize("case", ["ragged", "unaligned", "large_table"])
def test_cam_broadcast_kernel_widths(F, case):
    """The F=6 and F=12 kernels and the any-F one, exact and bit-identical
    on a rerun: E odd and not a multiple of a block's span, ids out of range
    both ways; a table one row into its storage (8 bytes off 16-byte
    alignment at F=6: the any-F kernel); a table of 4,096 cameras (192 KB
    at F=12)."""
    dev = card()
    g = torch.Generator(device="cpu").manual_seed(F)
    C, E = (4096, 65537) if case == "large_table" else (37, 99999)
    v = torch.randn(C + 1, F, generator=g).to(dev)
    v = v[1:] if case == "unaligned" and F % 2 == 0 else v[:C]
    ci = torch.randint(-5, C + 5, (E,), generator=g, dtype=torch.int32).to(dev)
    bk.reset_launch_counts()
    ours, again = bk.cam_broadcast(v, ci), bk.cam_broadcast(v, ci)
    assert bk.launch_counts()["cam_broadcast"] == 2
    assert torch.equal(ours.cpu(), bk.cam_broadcast_plain(v.cpu(), ci.cpu()))
    assert torch.equal(ours, again)


def test_cam_broadcast_kernel_empty():
    dev = card()
    v = torch.randn(4, 12, device=dev)
    out = bk.cam_broadcast(v, torch.empty(0, dtype=torch.int32, device=dev))
    assert out.shape == (0, 12)


@pytest.mark.parametrize("E,C,F", [(262144, 128, 6), (262144, 128, 42), (9999, 37, 6)])
def test_cam_reduce_kernel(E, C, F):
    """Against the masked index_add_; ids -1 and >= C dropped; bit-identical
    on a rerun (no atomics)."""
    dev = card()
    g = torch.Generator(device="cpu").manual_seed(E + F)
    y = torch.randn(E, F, generator=g).to(dev)
    ci = torch.randint(-2, C + 3, (E,), generator=g, dtype=torch.int32).to(dev)
    bk.reset_launch_counts()
    ours = bk.cam_reduce(y, ci, C)
    again = bk.cam_reduce(y, ci, C)
    assert bk.launch_counts()["cam_reduce"] == 2
    close(ours, bk.cam_reduce_plain(y, ci, C), 1e-4, 1e-5)
    assert torch.equal(ours, again)


@pytest.mark.parametrize("name", ["bench", "ragged"])
def test_make_schur_matvec_kernel(name):
    dev = card()
    prob = problem(name, dev)
    C = prob.R.shape[0]
    csr = bk.cam_csr(prob.cam_idx, C)
    _, V, W, _, _, _ = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    Vinv = ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=dev))).contiguous()
    v = torch.randn(C, 6, generator=torch.Generator(device="cpu").manual_seed(2)).to(dev)
    bk.reset_launch_counts()
    out = bk.make_schur_matvec(W, Vinv, prob.cam_idx, C)(v)
    assert bk.launch_counts()["schur_matvec"] == 1 and bk.launch_counts()["schur_off"] == 0
    close(out, bk.schur_matvec_plain(W, Vinv, prob.cam_idx, C)(v), 1e-4, 1e-4)


def skewed_schur_case(name, dev):
    """(W, Vinv, cam_idx, C) with the initialization BA's layout (K=16, and
    K=32 at a third of the landmark slots): random W, zero on the invalid
    slots, which all sit on camera 0; or the GBA stress shape (C=1024,
    P=131,072, K=8) with random W."""
    g = torch.Generator(device="cpu").manual_seed(16)
    if name == "stress":
        ci = torch.randint(0, 1024, (131072, 8), generator=g, dtype=torch.int32)
        ci = torch.sort(ci, dim=1).values
        valid = torch.ones(ci.shape, dtype=torch.bool)
    else:
        K = 16 if name == "init_ba_k16" else 32
        arr = problems.init_ba_problem_arrays(P=24576 if K == 16 else 8192, K=K)
        ci, valid = torch.as_tensor(arr["cam_idx"]), torch.as_tensor(arr["obs_valid"])
    P, K = ci.shape
    W = torch.randn(P, K, 6, 3, generator=g) * valid[..., None, None]
    Vinv = torch.randn(P, 3, 3, generator=g)
    C = 1024 if name == "stress" else 160
    return W.to(dev), Vinv.to(dev), ci.to(dev), C


@pytest.mark.parametrize("name", ["init_ba_k16", "init_ba_k32", "stress"])
def test_schur_off_kernel_skewed_and_stress(name):
    """off through schur_ops and make_schur_matvec (the same kernels, each
    under its own count): equal to the plain version, bit-identical rerun;
    camera 0 owns nearly all slots at the initialization BA's layout."""
    dev = card()
    W, Vinv, ci, C = skewed_schur_case(name, dev)
    v = torch.randn(C, 6, generator=torch.Generator(device="cpu").manual_seed(3)).to(dev)
    ref = bk.schur_matvec_plain(W, Vinv, ci, C)(v)
    bk.reset_launch_counts()
    off = bk.schur_ops(W, Vinv, bk.cam_csr(ci, C))[0]
    matvec = bk.make_schur_matvec(W, Vinv, ci, C)
    outs = [off(v), off(v), matvec(v), matvec(v)]
    counts = bk.launch_counts()
    assert counts["schur_off"] == 2 and counts["schur_matvec"] == 2
    for out in outs:
        close(out, ref, 1e-4, 1e-4)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])


@pytest.mark.parametrize("name", ["init_ba_k16", "init_ba_k32", "stress"])
def test_schur_rhs_wtv_kernels_skewed_and_stress(name):
    """rhs and wtv through schur_ops: one launch each per call, equal to the
    plain versions, bit-identical reruns; camera 0 owns nearly all slots at
    the initialization BA's layout.  rhs shares off's scratch: off between
    two rhs calls (and rhs between two off calls) changes nothing."""
    dev = card()
    W, Vinv, ci, C = skewed_schur_case(name, dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    v = torch.randn(C, 6, generator=g).to(dev)
    q = torch.randn(W.shape[0], 3, generator=g).to(dev)
    _, rhs_p, wtv_p = bk.schur_ops_plain(W, Vinv, ci, C)
    bk.reset_launch_counts()
    off, rhs, wtv = bk.schur_ops(W, Vinv, bk.cam_csr(ci, C))
    r1, o1, r2, o2, w1, w2 = rhs(q), off(v), rhs(q), off(v), wtv(v), wtv(v)
    counts = bk.launch_counts()
    assert counts["schur_rhs"] == 2 and counts["schur_wtv"] == 2 and counts["schur_off"] == 2
    close(r1, rhs_p(q), 1e-4, 1e-4)
    close(w1, wtv_p(v), 1e-4, 1e-4)
    assert torch.equal(r1, r2) and torch.equal(o1, o2) and torch.equal(w1, w2)


@pytest.mark.parametrize("name", ["local_ba_k16", "ragged_k12", "nan_landmark"])
def test_reproj_cost_kernel_client_shapes(name):
    """One thread per observation: equal to the plain version, bit-identical
    rerun; a NaN landmark gives a non-finite cost, as in the plain version."""
    dev = card()
    prob = client_problem("local_ba_k16" if name == "nan_landmark" else name, dev)
    if name == "nan_landmark":
        prob.X[123, 2] = float("nan")
    bk.reset_launch_counts()
    ours = bk.reproj_cost(*args(prob), prob.intr, DELTA)
    again = bk.reproj_cost(*args(prob), prob.intr, DELTA)
    assert bk.launch_counts()["reproj_cost"] == 2
    ref = bk.reproj_cost_plain(*args(prob), prob.intr, DELTA)
    if name == "nan_landmark":
        assert not torch.isfinite(ours) and not torch.isfinite(ref)
        return
    assert abs(float(ours) - float(ref)) < 1e-4 * abs(float(ref)) + 1e-2
    assert torch.equal(ours, again)


def test_reproj_cost_equals_normal_blocks_cost():
    """reproj_cost and normal_blocks' point kernel share the block layout,
    the per-observation cost and both sums: the same cost bit for bit."""
    prob = client_problem("ragged_k12", card())
    csr = bk.cam_csr(prob.cam_idx, prob.R.shape[0])
    cost = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)[5]
    assert torch.equal(bk.reproj_cost(*args(prob), prob.intr, DELTA), cost)


def test_off_and_cost_kernels_wide_landmarks():
    """K=300 slots: 512-thread blocks of one landmark; the Schur point
    kernel (off, rhs, wtv) then needs more than 48 KB of shared memory (its
    opt-in path)."""
    dev = card()
    prob = convert.ba_problem_from_numpy(
        problems.small_ba_problem_arrays(P=64, K=300, C=37, seed=301, fixed=3), dev)
    C = prob.R.shape[0]
    csr = bk.cam_csr(prob.cam_idx, C)
    _, V, W, _, _, cost = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    ours = bk.reproj_cost(*args(prob), prob.intr, DELTA)
    assert torch.equal(ours, cost)
    ref = bk.reproj_cost_plain(*args(prob), prob.intr, DELTA)
    assert abs(float(ours) - float(ref)) < 1e-4 * abs(float(ref)) + 1e-2
    Vinv = ba.inv3x3(ba._damp(V, torch.tensor(1e-4, device=dev))).contiguous()
    g = torch.Generator(device="cpu").manual_seed(4)
    v = torch.randn(C, 6, generator=g).to(dev)
    q = torch.randn(W.shape[0], 3, generator=g).to(dev)
    for fk, fp, x in zip(bk.schur_ops(W, Vinv, csr),
                         bk.schur_ops_plain(W, Vinv, prob.cam_idx, C), (v, q, v)):
        close(fk(x), fp(x), 1e-4, 1e-4)


def test_tracker_step_on_card_matches_cpu():
    """The CPU tracker runs the synthetic arc to a tracked state; its state
    is copied to the card and both process the next frame: same path, same
    associations, poses within 1e-3."""
    import numpy as np

    from test_torch_client import make_trajectory, make_world, render_frame, small_config
    from ccm_slam_tpu_torch.config import CameraConfig
    from ccm_slam_tpu_torch.runtime.tracker import OK, Tracker
    from ccm_slam_tpu_torch.utils.camera import Camera

    dev = card()
    cfg = small_config()
    cam_cfg = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    cpu = Tracker(cfg=cfg, cam=Camera.from_config(cam_cfg, "cpu"), device="cpu")
    points, desc_w = make_world()
    poses = make_trajectory(60)
    rng = np.random.RandomState(7)
    frames = [render_frame(points, desc_w, T, cpu.cam, rng, i * 0.05)
              for i, T in enumerate(poses[:12])]
    for f in frames[:11]:
        cpu.process_frame(f)
    assert cpu.state == OK and cpu.has_velocity

    def to_card(f):
        return convert.frame_from_numpy(convert.frame_fields(f), dev)

    gpu = Tracker(cfg=cfg, cam=Camera.from_config(cam_cfg, dev), device=dev, state=OK,
                  map=convert.map_state_from_numpy(convert.map_state_to_numpy(cpu.map), dev),
                  last_frame=to_card(cpu.last_frame), vel_R=cpu.vel_R.to(dev),
                  vel_t=cpu.vel_t.to(dev), has_velocity=True, ref_kf=cpu.ref_kf,
                  next_kf_id=cpu.next_kf_id, frames_since_kf=cpu.frames_since_kf,
                  kfs_since_init=cpu.kfs_since_init)
    out_c = cpu.process_frame(frames[11])
    out_g = gpu.process_frame(to_card(frames[11]))
    assert cpu.stats["path"] == gpu.stats["path"]
    assert torch.equal(out_c.mp, out_g.mp.cpu())
    torch.testing.assert_close(out_g.R_cw.cpu(), out_c.R_cw, rtol=0, atol=1e-3)
    torch.testing.assert_close(out_g.t_cw.cpu(), out_c.t_cw, rtol=0, atol=1e-3)


def test_kernels_are_repeatable():
    """No float atomics: the same inputs give bit-identical outputs."""
    prob = problem("bench", card())
    csr = bk.cam_csr(prob.cam_idx, prob.R.shape[0])
    a = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    b = bk.normal_blocks(*args(prob), prob.cam_fixed, prob.intr, DELTA, csr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_ba_solve_on_card_matches_cpu(branch):
    card()
    arr = (problems.small_ba_problem_arrays() if branch == "dense"
           else problems.arc_problem_arrays(C=100, P=1024, K=4))
    bk.reset_launch_counts()
    ours = ba.ba_solve(convert.ba_problem_from_numpy(arr), iters=20)
    counts = bk.launch_counts()
    ref = ba.ba_solve(convert.ba_problem_from_numpy(arr, "cpu"), iters=20)
    assert abs(float(ours[3]) - float(ref[3])) <= 0.05 * float(ref[3]) + 1e-3
    ctr = [-torch.einsum("cji,cj->ci", R.cpu(), t.cpu()) for R, t in (ours[:2], ref[:2])]
    assert float((ctr[0] - ctr[1]).norm(dim=-1).max()) < 5e-3
    assert counts["normal_blocks"] == 20 and counts["reproj_cost"] == 21
    assert counts["cam_broadcast"] == 1
    if branch == "pcg":
        assert counts["schur_rhs"] == 20 and counts["schur_off"] >= 20


def top2_case(name, dev):
    """Phase-5 cases of chip_smoke.py: (q, qv, t, tv) on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(7)
    Q, Tn = {"relocalization": (1024, 16384), "ragged": (100, 300),
             "invalid_queries": (128, 256), "one_target": (64, 500)}[name]
    q = torch.randint(0, 256, (Q, 32), generator=g, dtype=torch.uint8)
    t = torch.randint(0, 256, (Tn, 32), generator=g, dtype=torch.uint8)
    t[Tn // 2] = t[Tn // 3]  # a tie: the lower index must win
    qv = torch.ones(Q, dtype=torch.bool)
    tv = torch.rand(Tn, generator=g) >= 0.25
    if name == "invalid_queries":
        qv[-30:] = False
    if name == "one_target":
        tv[:] = False
        tv[Tn - 7] = True
    return [x.to(dev) for x in (q, qv, t, tv)]


@pytest.mark.parametrize("name", ["relocalization", "ragged", "invalid_queries", "one_target"])
def test_hamming_top2_kernel(name):
    args = top2_case(name, card())
    hk.reset_launch_counts()
    ours = hk.hamming_top2(*args)
    assert hk.launch_counts()["hamming_top2"] == 1
    ref = hk.hamming_top2_plain(*args)
    for a, b in zip(ours, ref):
        assert torch.equal(a.cpu(), b.cpu())
    again = hk.hamming_top2(*args)  # no atomics: bit-identical
    for a, b in zip(ours, again):
        assert torch.equal(a, b)


def top2_mma_case(name, dev):
    """(q, qv, t, tv) for the tensor-core kernel's edges: the main path's
    shapes; Q not a multiple of 16 and T not of 8, with queries equal to
    tied targets inside one 8-target tile, across two tiles, across two
    slices and at the last target, and one tie whose lower target is
    invalid; all targets equal; no valid target; invalid queries."""
    g = torch.Generator(device="cpu").manual_seed(17)
    Q, T = {"1024x1024": (1024, 1024), "1024x24576": (1024, 24576),
            "vocab_1024x32768": (1024, 32768)}.get(name, (37, 1003))
    q = torch.randint(0, 256, (Q, 32), generator=g, dtype=torch.uint8)
    t = torch.randint(0, 256, (T, 32), generator=g, dtype=torch.uint8)
    qv = torch.ones(Q, dtype=torch.bool)
    tv = torch.rand(T, generator=g) >= 0.25
    s = hk.slice_targets(T)
    ties = [(3, 5), (7, 8), (s - 1, s), (2 * s - 1, 2 * s), (T - 2, T - 1), (11, 12)]
    for i, (a, b) in enumerate(ties):
        t[b] = t[a]
        q[i] = t[a]
        q[i, i % 32] ^= 1  # distance 1 from both: the tie is not at zero
        tv[a] = tv[b] = True
    tv[11] = False  # the lower of the last pair cannot win
    if name == "all_equal":
        t[:] = t[0]
    if name == "no_valid_target":
        tv[:] = False
    if name == "invalid_queries":
        qv[::3] = False
    if name == "vocab_1024x32768":  # a keyframe's BoW transform: every word valid
        tv[:] = True
        qv[1000:] = False
    return [x.to(dev) for x in (q, qv, t, tv)]


@pytest.mark.parametrize("name", ["1024x1024", "1024x24576", "vocab_1024x32768", "ragged_ties",
                                  "all_equal", "no_valid_target", "invalid_queries"])
def test_hamming_top2_kernel_tiles_and_slices(name):
    """Exact against the plain version (all three outputs) and bit-identical
    on a rerun, where ties fall inside an MMA tile, across tiles and across
    the cluster's slices."""
    args = top2_mma_case(name, card())
    hk.reset_launch_counts()
    ours, again = hk.hamming_top2(*args), hk.hamming_top2(*args)
    assert hk.launch_counts()["hamming_top2"] == 2
    ref = hk.hamming_top2_plain(*(x.cpu() for x in args))
    for a, b, c in zip(ours, ref, again):
        assert torch.equal(a.cpu(), b)
        assert torch.equal(a, c)


def test_match_brute_on_card_matches_cpu():
    q, qv, t, tv = top2_case("relocalization", card())
    t[:1024] = q  # queries have exact matches in the arena
    hk.reset_launch_counts()
    ours = matching.match_brute(q, qv, t, tv, check_rotation=False)
    assert hk.launch_counts()["hamming_top2"] == 1
    ref = matching.match_brute(q.cpu(), qv.cpu(), t.cpu(), tv.cpu(), check_rotation=False)
    for a, b in zip(ours, ref):
        assert torch.equal(a.cpu(), b)
    assert int(ours[2].sum()) > 500


def test_orb_extract_on_card_matches_cpu():
    card()
    g = torch.Generator(device="cpu").manual_seed(3)
    img = torch.round(torch.nn.functional.avg_pool2d(
        torch.rand(1, 1, 244, 324, generator=g) * 255, 5, 1)[0, 0])
    kw = dict(n_features=300, n_levels=4, capacity=320)
    ours = orb.extract(img.cuda(), **kw)
    ref = orb.extract(img, **kw)
    same = (ours.valid.cpu() == ref.valid) & torch.all(ours.xy.cpu() == ref.xy, dim=1)
    assert float(same.float().mean()) >= 0.99
    shared = same & ref.valid
    d = hamming.hamming_pairwise(ours.desc.cpu(), ref.desc)[shared]
    assert float((d == 0).float().mean()) >= 0.99


@pytest.mark.parametrize("solver,V", [("dense", 48), ("pcg", 48), ("auto", 400)])
def test_pose_graph_on_card_matches_cpu_and_reruns_bit_identical(solver, V):
    """The essential graph's solve on the card: the same bits on a rerun
    (fixed-order segment sums, no float atomics) and the CPU's optimum: cost
    within 1e-4 relative; vertices within 1e-4 after dense LU steps, and
    within 5e-2 after truncated CG steps, whose rounding moves the solution
    along the chain's flat scale valley (on the CPU, dense and PCG land
    4.4 mm apart at V=48 with costs equal to 1e-6).  V=400 takes the PCG
    branch under "auto"."""
    from ccm_slam_tpu_torch.solvers import pose_graph as pg

    dev = card()
    f = problems.pose_graph_arrays(V=V, seed=1)
    S_c, cost_c = pg.optimize_pose_graph(convert.pose_graph_problem_from_numpy(f, "cpu"),
                                         iters=10, solver=solver)
    prob = convert.pose_graph_problem_from_numpy(f, dev)
    S_g, cost_g = pg.optimize_pose_graph(prob, iters=10, solver=solver)
    S_g2, cost_g2 = pg.optimize_pose_graph(prob, iters=10, solver=solver)
    assert torch.equal(cost_g, cost_g2)
    assert abs(float(cost_g) - float(cost_c)) <= 1e-4 * float(cost_c) + 1e-6
    for name in ("s", "R", "t"):
        assert torch.equal(getattr(S_g, name), getattr(S_g2, name)), name
        tol = 1e-4 if solver == "dense" else 5e-2
        torch.testing.assert_close(getattr(S_g, name).cpu(), getattr(S_c, name), rtol=1e-4,
                                   atol=tol)


def test_estimate_sim3_on_card_matches_cpu():
    """estimate_sim3 between two keyframes of a client map, the card (its
    match_brute on the hamming_top2 kernel) against the CPU, on the same
    RANSAC samples: equal matches and inliers, S_qc within 1e-4."""
    from ccm_slam_tpu_torch.config import tiny_test_config
    from ccm_slam_tpu_torch.ops import initializer
    from ccm_slam_tpu_torch.runtime import loop_closing
    from ccm_slam_tpu_torch.utils.camera import Camera

    dev = card()
    fields, _, _ = problems.client_map_arrays(n_kf=6, seed=3)
    cfg = tiny_test_config()

    def draw(okm):
        gen = torch.Generator().manual_seed(0)
        return initializer.draw_samples(okm.cpu(), 300, 3, generator=gen).to(okm.device)

    out = {}
    for d in ("cpu", dev):
        m = convert.map_state_from_numpy(fields, d)
        out[str(d)] = loop_closing.estimate_sim3(m, 5, 0, Camera.from_config(cfg.camera, d), cfg,
                                                 idx=draw)
    c, g = out["cpu"], out[str(dev)]
    assert int(g["n_matches"]) == int(c["n_matches"]) >= 20
    assert int(g["n_inliers"]) == int(c["n_inliers"]) >= 20
    assert bool(g["success"]) == bool(c["success"])
    torch.testing.assert_close(g["matched_mp"].cpu(), c["matched_mp"])
    for name in ("s", "R", "t"):
        torch.testing.assert_close(getattr(g["S_qc"], name).cpu(), getattr(c["S_qc"], name),
                                   rtol=1e-4, atol=1e-4)


def server_inputs(dev):
    """(config, messages, vocabulary): the first two messages of a client map
    (``problems.client_map_arrays``; ``publish_client`` on the CPU, 4
    keyframes and 600 landmarks each) and a 128-word vocabulary trained on
    the CPU, moved to ``dev``."""
    import dataclasses

    from ccm_slam_tpu_torch.config import tiny_test_config
    from ccm_slam_tpu_torch.ops import bow
    from ccm_slam_tpu_torch.runtime import communicator as comm

    m = convert.map_state_from_numpy(problems.client_map_arrays(n_kf=6, seed=3)[0], "cpu")
    st = comm.ClientCommState.create(16, 512)
    msgs = []
    for _ in range(2):
        msg, st = comm.publish_client(m, st, 0, max_kfs=4, max_mps=600)
        msgs.append(msg)
    vocab = bow.train_vocabulary(m.kfs.desc.reshape(-1, 32), m.kfs.feat_valid.reshape(-1),
                                 n_words=128, iters=3, generator=torch.Generator().manual_seed(0))

    def move(obj):
        if torch.is_tensor(obj):
            return obj.to(dev)
        if dataclasses.is_dataclass(obj):
            return dataclasses.replace(obj, **{f.name: move(getattr(obj, f.name))
                                               for f in dataclasses.fields(obj)
                                               if torch.is_tensor(getattr(obj, f.name))
                                               or dataclasses.is_dataclass(getattr(obj, f.name))})
        return obj

    return tiny_test_config(), [move(x) for x in msgs], move(vocab)


def assert_maps_match(ours, ref, atol=1e-5):
    import numpy as np

    a, b = convert.map_state_to_numpy(ours), convert.map_state_to_numpy(ref)
    for sec in ("kfs", "mps"):
        for name, x in a[sec].items():
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, b[sec][name], rtol=1e-5, atol=atol, err_msg=name)
            else:
                np.testing.assert_array_equal(x, b[sec][name], err_msg=name)
    for n in ("next_kf", "next_mp", "insert_counter"):
        assert int(a[n]) == int(b[n]), n


def test_ingest_on_card_matches_cpu():
    """Two messages through ``Server.ingest`` on the card and on the CPU:
    the same acks and tables, integers equal, floats to 1e-5 (the BoW
    transform on the ``hamming_top2`` kernel)."""
    from ccm_slam_tpu_torch.runtime.server import Server
    from ccm_slam_tpu_torch.utils.camera import Camera

    dev = card()
    out = {}
    for d in ("cpu", dev):
        cfg, msgs, vocab = server_inputs(d)
        srv = Server(cfg=cfg, cam=Camera.from_config(cfg.camera, d), vocab=vocab, n_agents=1,
                     device=d)
        acks = [srv.ingest(0, msg) for msg in msgs]
        out[str(d)] = (srv, acks)
    (c, c_acks), (g, g_acks) = out["cpu"], out[str(dev)]
    for a, b in zip(g_acks, c_acks):
        assert (a.ack_kf_ids.tolist(), a.ack_mp_ids.tolist(), a.weak_ack_kf_id) == (
            b.ack_kf_ids.tolist(), b.ack_mp_ids.tolist(), b.weak_ack_kf_id)
    assert g.agents[0].kf_table == c.agents[0].kf_table and len(c.agents[0].kf_table) == 6
    assert g.agents[0].mp_table == c.agents[0].mp_table
    assert_maps_match(g.maps[0], c.maps[0])
    torch.testing.assert_close(g.matcher.db.vectors.cpu(), c.matcher.db.vectors, atol=1e-6,
                               rtol=0)


def test_merge_maps_on_card_matches_cpu():
    from ccm_slam_tpu_torch.models import map_store as ms
    from ccm_slam_tpu_torch.utils.lie import so3_exp

    dev = card()
    fa, _, _ = problems.client_map_arrays(n_kf=6, seed=3, kf_cap=32, mp_cap=1024)
    fb, _, _ = problems.client_map_arrays(n_kf=5, seed=4)
    R = so3_exp(torch.tensor([0.02, -0.1, 0.05]))
    out = {}
    for d in ("cpu", dev):
        a, b = convert.map_state_from_numpy(fa, d), convert.map_state_from_numpy(fb, d)
        b = ms.erase_keyframes(b, torch.arange(16, device=d) == 2)
        out[str(d)] = ms.merge_maps(a, b, torch.tensor(1.3, device=d), R.to(d),
                                    torch.tensor([0.4, 0.0, -0.2], device=d))
    assert_maps_match(out[str(dev)], out["cpu"])


def test_pack_map_msg_of_card_tensors_gives_cpu_bytes():
    from ccm_slam_tpu_torch.runtime import wire

    dev = card()
    _, msgs_c, _ = server_inputs("cpu")
    _, msgs_g, _ = server_inputs(dev)  # the same messages, moved to the card
    for mc, mg in zip(msgs_c, msgs_g):
        data = wire.pack_map_msg(mc)
        assert mg.kfs.valid.device.type == "cuda"
        assert wire.pack_map_msg(mg) == data
        back = wire.unpack_map_msg(data, device=dev)
        ref = wire.unpack_map_msg(data, device="cpu")
        for name in ("kfs", "mps"):
            for f, x in getattr(back, name).__dict__.items():
                assert x.device.type == "cuda"
                assert torch.equal(x.cpu(), getattr(getattr(ref, name), f)), (name, f)


@pytest.mark.parametrize("C,K", [(40, 16), (100, 4)], ids=["dense", "pcg"])
def test_dist_ba_over_nccl_matches_the_cpu_solve(C, K):
    """The landmark-sharded GBA at world size 1 over NCCL on the card equals
    the card's ba_solve to the bit and lands where the CPU's ba_solve does
    (cost within 5% + 1e-3, camera centres within 5e-3:
    __graft_entry__.py:144-148); a rerun is bit-identical.  The dense case
    has K=16 observations a landmark: at K=4 (C=40, P=1024) the CPU's own
    ba_solve moves the centres by 2e-3 between 1 and 4 threads, too near
    the bound to compare two devices."""
    from ccm_slam_tpu_torch.parallel import dist_ba

    dev = card()
    mesh = dist_ba.make_mesh(dev)
    try:
        assert mesh.backend == "nccl" and mesh.world_size == 1
        arr = problems.arc_problem_arrays(C=C, P=1024, K=K)
        probs = dist_ba.shard_problem(convert.ba_problem_from_numpy(arr, dev), mesh)
        R, t, X, cost = dist_ba.dist_ba_solve(probs, mesh, iters=12)
        R_g, t_g, X_g, cost_g, _ = ba.ba_solve(convert.ba_problem_from_numpy(arr, dev), iters=12)
        assert torch.equal(cost, cost_g) and torch.equal(t, t_g) and torch.equal(X, X_g)
        R_c, t_c, _, cost_c, _ = ba.ba_solve(convert.ba_problem_from_numpy(arr, "cpu"),
                                             iters=12)
        assert abs(float(cost) - float(cost_c)) <= 0.05 * float(cost_c) + 1e-3
        centre = -torch.einsum("cji,cj->ci", R.cpu(), t.cpu())
        centre_c = -torch.einsum("cji,cj->ci", R_c, t_c)
        assert float((centre - centre_c).norm(dim=-1).max()) < 5e-3
        again = dist_ba.dist_ba_solve(probs, mesh, iters=12)
        assert torch.equal(again[3], cost) and torch.equal(again[1], t)
    finally:
        torch.distributed.destroy_process_group()
