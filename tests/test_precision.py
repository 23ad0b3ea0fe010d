"""Every float32 contraction on the device path pins Precision.HIGHEST.

A GPU runs float32 matmuls as TF32 (~3 decimal digits) when no precision is
given, which breaks the parity contract; the CPU never does, so the CPU
tests cannot see it.  This checks the traced programs instead: any f32
`dot_general` without HIGHEST fails here, without a card."""

import jax
from jax.extend.core import ClosedJaxpr, Jaxpr
import jax.numpy as jnp
import numpy as np
import pytest

from spectrogram_tpu.config import SpectrogramConfig
from spectrogram_tpu.models.spectrogram import SpectrogramPipeline

CFG = SpectrogramConfig(sample_rate=8000.0, window_period=0.032,
                        hop_period=0.008, viewport_height=64, viewport_rows=16)


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def f32_dots(jaxpr):
    """(precision, shapes) of every f32 dot_general, nested jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            found.append((eqn.params["precision"],
                          [v.aval.shape for v in eqn.invars]))
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                found.extend(f32_dots(sub))
    return found


def _is_highest(precision) -> bool:
    if precision is None:
        return False
    pair = precision if isinstance(precision, tuple) else (precision, precision)
    return all(p == jax.lax.Precision.HIGHEST for p in pair)


@pytest.mark.parametrize("backend", ["mxu", "xla"])
@pytest.mark.parametrize("entry", ["push_impl", "process", "render_viewport"])
def test_f32_dots_pin_highest(entry, backend):
    p = SpectrogramPipeline(CFG, chunk_hops=4, stft_backend=backend)
    state = p.init_state(2)
    if entry == "push_impl":
        args = (state, jnp.zeros((2, p.chunk_size, 2), jnp.float32))
        fn = p.push_impl
    elif entry == "process":
        args = (jnp.zeros((2, 4 * p.chunk_size, 2), jnp.float32),)
        fn = p.process
    else:
        args = (state,)
        fn = lambda st: p.render_viewport(st, width=24)  # noqa: E731
    dots = f32_dots(jax.make_jaxpr(fn)(*args).jaxpr)
    assert dots, "no f32 contraction found: the walk is broken"
    loose = [d for d in dots if not _is_highest(d[0])]
    assert not loose, loose


def test_walk_catches_a_default_precision_dot():
    """The checker itself: a plain f32 einsum (default precision) fails."""
    fn = lambda a, b: jnp.einsum("ij,jk->ik", a, b)  # noqa: E731
    x = np.ones((4, 4), np.float32)
    dots = f32_dots(jax.make_jaxpr(fn)(x, x).jaxpr)
    assert dots and not _is_highest(dots[0][0])
