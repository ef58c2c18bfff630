"""PyTorch port of the in-network-learning system in `src/repro/`, for an
NVIDIA H100.

The package mirrors `src/repro/` file for file; each module names the JAX
module it is held against.  It imports torch and numpy, never JAX and
nothing of `repro`.  Every Pallas kernel of the JAX package on a ported path
is a hand-written CUDA kernel here (`kernels/csrc/`), with a plain PyTorch
version beside it that CPU tensors take.

Entry points take `device=None`, which means "cuda": without a card they
raise rather than carry on on the CPU.  Pass `device="cpu"` to run the
plain versions on the CPU, as the tests do.

The helpers below (`common.py`) resolve lazily (PEP 562), so importing the
package loads no torch: a cluster worker process
(`python -m repro_torch.cluster.worker`) imports only the channel layer,
which needs numpy and the standard library.
"""
import importlib

_EXPORTS = ("resolve_device", "as_generator", "tree_map", "tree_leaves",
            "tree_unflatten", "tree_stack", "value_and_grad", "as_input")

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.common"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
