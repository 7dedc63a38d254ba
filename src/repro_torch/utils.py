"""Small shared utilities (``repro.utils.misc``).

JAX's ``Timer``, ``timeit_median`` and ``block_until_ready`` have no
counterpart: the package reads no host clock (callers time with CUDA
events or ``obs.clock``).  ``repro.utils.compat.shard_map_compat`` is
JAX-only and has none either.
"""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (every entry point's default) raises when no card is
    present: the port never drops to the CPU on its own.  Callers that want
    the plain PyTorch path ask for ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def nest(flat: dict, sep: str = ".") -> dict:
    """``{"a.b.c": leaf}`` as ``{"a": {"b": {"c": leaf}}}``."""
    tree: dict = {}
    for name, leaf in flat.items():
        node, parts = tree, name.split(sep)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}EB"


def tree_size_bytes(tree) -> int:
    """Total bytes of every tensor or array (a ``meta`` tensor included:
    its shape and dtype) in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return int(np.prod(tree.shape)) * np.dtype(tree.dtype).itemsize
    return 0


def flatten_dotted(tree: dict, prefix: str = "") -> dict:
    """``{"a": {"b": leaf}}`` as ``{"a.b": leaf}`` (the inverse of
    :func:`nest`)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def unstack_layers(params: dict, stacked: tuple) -> dict:
    """A JAX params pytree of numpy leaves whose subtrees named in
    ``stacked`` hold layers stacked [L, ...] for ``scan``, as a
    ``state_dict``: ``<name>.<i>.<leaf>`` for layer i of each, CPU
    tensors."""
    state = {}
    for name, leaf in flatten_dotted(params).items():
        leaf = np.asarray(leaf)
        top, _, rest = name.partition(".")
        if top in stacked and rest:
            for i in range(leaf.shape[0]):
                state[f"{top}.{i}.{rest}"] = torch.from_numpy(leaf[i].copy())
        else:
            state[name] = torch.from_numpy(leaf.copy())
    return state


def stack_layers(state: dict, stacked: tuple) -> dict:
    """The inverse of :func:`unstack_layers`: a ``state_dict`` (tensors or
    numpy arrays) as the JAX params pytree of numpy arrays, nested by the
    dotted names, ``<name>.<i>.<leaf>`` stacked into ``<name>.<leaf>``
    [L, ...] in layer order for each ``name`` in ``stacked``."""
    flat, layers = {}, {}
    for name, leaf in state.items():
        top, _, rest = name.partition(".")
        if top in stacked:
            i, leaf_name = rest.split(".", 1)
            layers.setdefault((top, leaf_name), {})[int(i)] = _host(leaf)
        else:
            flat[name] = _host(leaf)
    for (top, leaf_name), by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{top}.*.{leaf_name}: layers "
                             f"{sorted(by_layer)}")
        flat[f"{top}.{leaf_name}"] = np.stack(
            [by_layer[i] for i in range(len(by_layer))])
    return nest(flat)
