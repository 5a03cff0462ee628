"""How the port's tests compile their JAX references.

The references are small and run once: their integer-valued results do
not depend on XLA's backend optimizations, while the optimizing compile
costs seconds per program.
"""

XLA_FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def run_fast(jitted, *args):
    """``jitted(*args)``, compiled with :data:`XLA_FAST`."""
    return jitted.lower(*args).compile(compiler_options=XLA_FAST)(*args)
