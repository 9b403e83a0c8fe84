"""The port's two-float (hi + lo) state against exact arithmetic and the JAX
`parallel/hilo.py`, on the CPU.

Tolerances: none.  Two-sum is an error-free transform, so s + e equals
a + b exactly (checked in f64, where the sum of two f32 values is exact);
the f64 -> (hi, lo) -> f64 round trip keeps ~48 bits (hi + lo carries the
f64 value to within |x| 2^-48); `apply_step` is elementwise f32 on both
sides in the same operation order, so it must agree with JAX bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import torch

from bundle_adjustment_tpu.models.problem import ParamState as JParamState
from bundle_adjustment_tpu.parallel import hilo as JH
from bundle_adjustment_tpu_torch.models.problem import ParamState
from bundle_adjustment_tpu_torch.parallel import hilo
from _torch_threads import one_torch_thread  # noqa: F401


def _state(rng, dtype, scale=1.0):
    return ParamState(
        points=torch.as_tensor(rng.normal(0, 1e3 * scale, (64, 3)), dtype=dtype),
        io=torch.as_tensor(rng.normal(0, scale, (1, 3)), dtype=dtype),
        dist=torch.as_tensor(rng.normal(0, 1e-4 * scale, (1, 7)), dtype=dtype),
        eo=torch.as_tensor(rng.normal(0, 1e3 * scale, (10, 6)), dtype=dtype))


def test_two_sum_is_exact():
    """Magnitudes within about 1e-3..1e3, so a + b is exact in f64: the
    two exponents stay within the 29 bits that f64 has beyond f32."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 4096) * 10.0 ** rng.integers(-3, 4, 4096)
    b = rng.normal(0, 1, 4096) * 10.0 ** rng.integers(-3, 4, 4096)
    a, b = a.astype(np.float32), b.astype(np.float32)
    b[:1024] = -a[:1024] * (1 + rng.normal(0, 1e-6, 1024)).astype(np.float32)
    b[1024:1100] = -a[1024:1100]  # exact cancellation
    s, e = hilo._two_sum(torch.as_tensor(a), torch.as_tensor(b))
    assert s.dtype == e.dtype == torch.float32
    lhs = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    np.testing.assert_array_equal(lhs, a.astype(np.float64)
                                  + b.astype(np.float64))
    np.testing.assert_array_equal(s.numpy(), a + b)  # s = fl(a + b)


def test_from_f64_to_f64_round_trip():
    rng = np.random.default_rng(1)
    st64 = _state(rng, torch.float64)
    s = hilo.from_f64(st64)
    assert all(t.dtype == torch.float32 for t in (*s.hi, *s.lo))
    back = hilo.to_f64(s)
    for x, y, h in zip(st64, back, s.hi):
        torch.testing.assert_close(h, x.float(), rtol=0, atol=0)
        assert float((y - x).abs().max()) <= 2.0 ** -48 * float(
            x.abs().max())
    z = hilo.from_f32(s.hi)
    assert all(float(t.abs().max()) == 0.0 for t in z.lo)
    assert all(torch.equal(a, b) for a, b in zip(z.hi, s.hi))


def test_apply_step_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    s = hilo.from_f64(_state(rng, torch.float64))
    dxp = torch.as_tensor(rng.normal(0, 1e-3, (64, 3)), dtype=torch.float32)
    dxc = torch.as_tensor(rng.normal(0, 1e-5, (10, 6)), dtype=torch.float32)
    dxg = torch.as_tensor(rng.normal(0, 1e-6, (10,)), dtype=torch.float32)

    def j(st):
        return JParamState(*(jnp.asarray(t.numpy()) for t in st))

    sj = JH.HiLoState(hi=j(s.hi), lo=j(s.lo))
    for alpha in (1.0, 0.75):
        new, mdx = hilo.apply_step(s, dxp, dxc, dxg, alpha=alpha)
        new_j, mdx_j = JH.apply_step(sj, jnp.asarray(dxp.numpy()),
                                     jnp.asarray(dxc.numpy()),
                                     jnp.asarray(dxg.numpy()), alpha=alpha)
        for a, b in zip((*new.hi, *new.lo), (*new_j.hi, *new_j.lo)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(mdx) == float(mdx_j)
