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


def fast(jitted):
    """``jitted`` compiled with :data:`XLA_FAST` once for each tree,
    shape and dtype of its arguments (:func:`run_fast` compiles on every
    call): for a step called many times, as an ``Engine`` calls it."""
    import jax

    done = {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((getattr(a, "shape", None),
                            str(getattr(a, "dtype", type(a))))
                           for a in leaves))
        if key not in done:
            done[key] = jitted.lower(*args).compile(
                compiler_options=XLA_FAST)
        return done[key](*args)

    return call
