"""The port's frequency-domain simulator (qups_tpu_torch.ops.greens_freq and
the plain version of kernel K3) against qups_tpu's: the per-bin GEMM against
the Pallas kernel run in interpret mode, and whole simulations against
greens_freq with both JAX engines."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qups_tpu.ops.greens_freq import _freq_gemm, _host_plan  # noqa: E402
from qups_tpu.ops.greens_freq import greens_freq as greens_freq_ref  # noqa: E402
from qups_tpu.ops.greens_freq_pallas import _gf_call, freq_gemm_pallas  # noqa: E402
from qups_tpu_torch.ops import greens_freq_cuda  # noqa: E402
from qups_tpu_torch.ops.greens_freq import greens_freq, host_plan, prologue  # noqa: E402

from test_greens_freq import problem  # noqa: E402 (the JAX tests' fixture)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _plans(kern, ps, pn, pv, kw, fsr=1.0):
    ref = _host_plan(kern, ps, pn, pv, T=kw["T"], s0=kw["s0"], t0k=kw["t0k"],
                     fs=kw["fs"], cinv=kw["cinv"], R0=kw["R0"], fsr=fsr,
                     rtol=1e-6, precision="highest")
    got = host_plan(kern, ps, pn, pv, T=kw["T"], s0=kw["s0"], t0k=kw["t0k"],
                    fs=kw["fs"], cinv=kw["cinv"], fsr=fsr, rtol=1e-6)
    return ref, got


def test_host_plan_matches_reference():
    kern, ps, amp, pn, pv, kw = problem()
    ref, got = _plans(kern, ps, pn, pv, kw)
    assert (got["L"], got["k0"], got["k1"]) == (ref["L"], ref["k0"], ref["k1"])
    assert got["phc"] == ref["phc"]
    np.testing.assert_allclose(got["Kr"], ref["Kr"], rtol=1e-12)


@pytest.mark.parametrize("att", [0.0, 0.05], ids=["lossless", "attenuated"])
def test_gemm_matches_pallas_kernel(att):
    """The plain K3 against the TPU kernel in interpret mode, on the same
    geometry. Both build the angle as 2 pi frac(k q)."""
    kern, ps, amp, pn, pv, kw = problem(S=13)
    ref_plan, plan = _plans(kern, ps, pn, pv, kw)
    st = ref_plan["st"]
    G = np.asarray(freq_gemm_pallas(
        jnp.asarray(ref_plan["phc"]), jnp.asarray(ps), jnp.asarray(amp),
        jnp.asarray(pn), jnp.asarray(pv), L=st["L"], k0=st["k0"], F=st["F"],
        R0=st["R0"], fsr=1.0, interpret=True, att=att))
    q1, w1, q2, w2 = prologue(plan["phc"], ps, amp, pn, pv, R0=kw["R0"],
                              fsr=1.0, device="cpu")
    att_q = att * 6.283185307179586 / float(plan["phc"])
    got = greens_freq_cuda.freq_gemm_plain(q1, w1, q2, w2, k0=plan["k0"],
                                           F=plan["k1"] - plan["k0"], att=att_q)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), G[..., 0] + 1j * G[..., 1]) < 1e-4


def test_gemm_subelements_match_xla_engine():
    """Sub-elements (En = 2) are summed into the phasors; the Pallas kernel
    takes one sub-element only, so the XLA engine is the reference. 2e-4,
    not 1e-4: the XLA engine runs its phasor recurrence along the whole
    band, whose float32 drift the direct evaluation does not have."""
    kern, ps, amp, pn, pv, kw = problem(S=9)
    pn2 = np.concatenate([pn, pn + np.float32([1e-4, 0, 0])], axis=1)
    ref_plan, plan = _plans(kern, ps, pn2, pv, kw)
    st = ref_plan["st"]
    G = np.asarray(_freq_gemm(jnp.asarray(ref_plan["phc"]), jnp.asarray(ps),
                              jnp.asarray(amp), jnp.asarray(pn2), jnp.asarray(pv),
                              L=st["L"], k0=st["k0"], F=st["F"], R0=st["R0"],
                              fsr=1.0))
    q1, w1, q2, w2 = prologue(plan["phc"], ps, amp, pn2, pv, R0=kw["R0"],
                              fsr=1.0, device="cpu")
    got = greens_freq_cuda.freq_gemm_plain(q1, w1, q2, w2, k0=plan["k0"],
                                           F=plan["k1"] - plan["k0"], max_elems=64)
    assert _rel(got.numpy(), G[..., 0] + 1j * G[..., 1]) < 2e-4


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("case", ["real", "complex_kernel", "complex_amp"])
def test_greens_freq_matches_reference(case, engine):
    """Whole simulations. Against the Pallas engine (interpret mode) the
    default 1e-4; against the XLA engine 1e-4 too (measured 3.7e-5)."""
    kern, ps, amp, pn, pv, kw = problem(S=11)
    if case == "complex_kernel":
        kern = kern * np.exp(0.3j * np.arange(kern.shape[0]))
    if case == "complex_amp":
        amp = amp * np.exp(1j * np.linspace(0, 3, amp.shape[0]))
    ref = greens_freq_ref(kern, ps, amp, pn, pv, engine=engine,
                          out="complex" if case != "real" else "auto", **kw)
    got = greens_freq(kern, ps, amp, pn, pv, device="cpu", **kw)
    assert got.dtype == (torch.float32 if case == "real" else torch.complex64)
    assert _rel(got.numpy(), ref) < 1e-4


def test_greens_freq_resampled_kernel_and_attenuation():
    """fsr != 1 resamples the kernel with lanczos3 on the host; alpha0
    attenuates through the per-bin weights."""
    kern, ps, amp, pn, pv, kw = problem(S=7)
    kw = dict(kw, fsr=2.0)
    k2 = np.interp(np.arange(30) / 2.0, np.arange(15), kern).astype(np.float32)
    ref = greens_freq_ref(k2, ps, amp, pn, pv, engine="xla", alpha0=0.5, **kw)
    got = greens_freq(k2, ps, amp, pn, pv, alpha0=0.5, device="cpu", **kw)
    assert _rel(got.numpy(), ref) < 1e-4
    lossless = greens_freq(k2, ps, amp, pn, pv, device="cpu", **kw)
    assert float(got.abs().max()) < 0.9 * float(lossless.abs().max())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_gemm_directivity_matches_pallas_kernel(bf16):
    """K3(c), and K3(b) with it: the plain K3 with sinc slopes s1, s2 (and
    bf16 operands) against the TPU kernel's has_dir variant in interpret
    mode, on the same operands. bf16: 5e-3 (a torch.sin and an XLA sin that
    differ by an ulp can round to neighbouring bf16 values)."""
    rng = np.random.default_rng(50)
    S, N, M, k0, F = 21, 6, 5, 30, 40
    q1 = rng.uniform(0, 0.05, (S, N)).astype(np.float32)
    q2 = rng.uniform(0, 0.05, (S, M)).astype(np.float32)
    w1 = rng.uniform(0.5, 1.5, (S, N)).astype(np.float32)
    w2 = rng.uniform(0.5, 1.5, (S, M)).astype(np.float32)
    s1 = rng.uniform(-0.02, 0.02, (S, N)).astype(np.float32)
    s2 = rng.uniform(-0.02, 0.02, (S, M)).astype(np.float32)
    G = np.asarray(_gf_call(*(jnp.asarray(a) for a in (q1.T, w1.T, q2, w2, s1.T, s2)),
                            F=F, FB=8, SC=128, k0=k0, bf16=bf16, interpret=True))
    t = [torch.as_tensor(a) for a in (q1, w1, q2, w2, s1, s2)]
    got = greens_freq_cuda.freq_gemm_plain(t[0][..., None], t[1][..., None],
                                           t[2][..., None], t[3][..., None], k0=k0,
                                           F=F, s1=t[4], s2=t[5], bf16=bf16)
    assert _rel(got.numpy(), G[..., 0] + 1j * G[..., 1]) < (5e-3 if bf16 else 1e-4)
    plain = greens_freq_cuda.freq_gemm(t[0][..., None], t[1][..., None],
                                       t[2][..., None], t[3][..., None], k0=k0, F=F)
    assert float((got - plain).abs().max()) > 1e-3 * float(plain.abs().max())
    with pytest.raises(ValueError, match="both"):
        greens_freq_cuda.freq_gemm(t[0][..., None], t[1][..., None], t[2][..., None],
                                   t[3][..., None], k0=k0, F=F, s1=t[4])


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_greens_freq_bf16_matches_reference(engine):
    """K3(b): greens_freq(precision='bf16') in both packages, rel-norm
    < 5e-3 (tests/test_greens_freq.py:186's bound); 'default' is the float32
    result."""
    kern, ps, amp, pn, pv, kw = problem(S=11)
    ref = np.asarray(greens_freq_ref(kern, ps, amp, pn, pv, engine=engine,
                                     precision="bf16", **kw))
    got = greens_freq(kern, ps, amp, pn, pv, precision="bf16", device="cpu", **kw).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-3
    f32 = greens_freq(kern, ps, amp, pn, pv, device="cpu", **kw)
    assert torch.equal(greens_freq(kern, ps, amp, pn, pv, precision="default", device="cpu",
                                   **kw), f32)
    with pytest.raises(ValueError, match="precision"):
        greens_freq(kern, ps, amp, pn, pv, precision="tf32", device="cpu", **kw)


def test_wrapper_on_cpu_runs_plain():
    kern, ps, amp, pn, pv, kw = problem(S=5)
    before = greens_freq_cuda.LAUNCHES
    auto = greens_freq(kern, ps, amp, pn, pv, device="cpu", **kw)
    plain = greens_freq(kern, ps, amp, pn, pv, kernel="plain", device="cpu", **kw)
    assert greens_freq_cuda.LAUNCHES == before
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError, match="CUDA"):
        greens_freq(kern, ps, amp, pn, pv, kernel="cuda", device="cpu", **kw)


def _k3_tensor_core_operands(A: torch.Tensor, B: torch.Tensor):
    """K3(b)'s operands of one bin in the kernel's layout, as float32: the
    left (2N x 2S), whose 16-row tiles hold the Gr rows (Re, -Im) of 8
    receivers and then their Gi rows (Im, Re), and the right (2S x M) with
    rows (Br, Bi) interleaved; A (S, N), B (S, M) complex, bf16-rounded."""
    S, N = A.shape
    Np = -(-N // 8) * 8
    L = torch.zeros((2 * Np, S, 2))
    n = torch.arange(N)
    rr = 16 * (n // 8) + n % 8
    L[rr, :, 0], L[rr, :, 1] = A.real.T, -A.imag.T
    L[rr + 8, :, 0], L[rr + 8, :, 1] = A.imag.T, A.real.T
    R = torch.stack((B.real, B.imag), 1).reshape(2 * S, -1)
    return L.reshape(2 * Np, 2 * S), R, rr


@pytest.mark.parametrize("S,N,M", [(16, 8, 8), (37, 13, 20), (48, 128, 128)])
def test_k3_tensor_core_layout_matches_plain(S, N, M):
    """The real-block product of K3(b), in the kernel's row order, through a
    plain real float32 product on the same bf16 operands, gives
    freq_gemm_plain(bf16=True) to float32 rounding; the operands are the
    plain version's own (_phasors, seeded numpy geometry)."""
    rng = np.random.default_rng(70 + S)
    q1 = torch.as_tensor(rng.uniform(0.05, 0.5, (S, N, 1)).astype(np.float32))
    q2 = torch.as_tensor(rng.uniform(0.05, 0.5, (S, M, 1)).astype(np.float32))
    w1 = torch.as_tensor(rng.uniform(0.5, 1.5, (S, N, 1)).astype(np.float32))
    w2 = torch.as_tensor(rng.standard_normal((S, M, 1)).astype(np.float32))
    k = torch.tensor([37.0])
    A = greens_freq_cuda._phasors(q1, w1, k, 0.0, bf16=True)[0]
    B = greens_freq_cuda._phasors(q2, w2, k, 0.0, bf16=True)[0]
    L, R, rr = _k3_tensor_core_operands(A, B)
    assert torch.equal(L.to(torch.bfloat16).float(), L)  # exact in bf16
    G = L @ R
    got = torch.complex(G[rr], G[rr + 8])
    ref = greens_freq_cuda.freq_gemm_plain(q1, w1, q2, w2, k0=37, F=1, bf16=True)[0]
    assert float((got - ref).abs().max()) < 1e-6 * float(ref.abs().max())
