"""JAX references of the port's parity tests, compiled cheaply.

A reference runs once per test, and XLA's CPU compile of it is most of a
parity test's time.  `FAST_COMPILE` turns off LLVM's optimization passes
(the HLO the reference computes is the same; float32 arithmetic is not
reassociated either way), which takes about a third off the compile of a
train step.  `run_jax` compiles and calls a function once; `FastJit`
wraps an already-jitted function (the JAX package's train step), compiling
it once per input shapes and dtypes."""

import jax

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _signature(args):
    leaves, tree = jax.tree.flatten(args)
    return tree, tuple((getattr(x, "shape", None), str(getattr(x, "dtype", type(x))))
                       for x in leaves)


class FastJit:
    """`jitted(*args)`, each input signature lowered and compiled once with
    FAST_COMPILE."""

    def __init__(self, jitted):
        self.jitted, self.compiled = jitted, {}

    def __call__(self, *args):
        key = _signature(args)
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
        return self.compiled[key](*args)


def run_jax(fn, *args):
    """jax.jit(fn)(*args), compiled with FAST_COMPILE."""
    return FastJit(jax.jit(fn))(*args)
