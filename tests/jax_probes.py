"""The JAX probe tools (tools/*.py) as the oracles of their ports in
pvot_torch.tools: loaded by path, their pallas_calls run in Pallas interpret
mode with each call's operands and outputs kept."""

import importlib.util
import os

import jax
import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def capture(probes, names):
    """{probe: (operands, outputs)} of each named probe's pallas_call, run in
    interpret mode (the probe's own assertions run too)."""
    orig = jpl.pallas_call
    calls, current = {}, {}

    def pallas_call(*args, **kwargs):
        call = orig(*args, interpret=True, **kwargs)

        def run(*inputs):
            result = call(*inputs)
            calls[current["name"]] = ([np.asarray(v) for v in inputs],
                                      [np.asarray(v) for v in jax.tree_util.tree_leaves(result)])
            return result

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "pallas_call", pallas_call)
        for name in names:
            current["name"] = name
            probes[name]()
    return calls


def tensors(case, arrays):
    """The arrays as the case's operand tensors on the CPU (a bf16 plane
    from its float32 values, exactly)."""
    dtypes = case.dtypes or (None,) * len(arrays)
    return tuple(torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                       if d == torch.bfloat16 else a)).to(d)
                 if d is not None else torch.from_numpy(np.array(a))
                 for a, d in zip(arrays, dtypes))
