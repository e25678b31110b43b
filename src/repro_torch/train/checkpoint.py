"""Fault-tolerant checkpointing of a training state.

Counterpart of ``repro/train/checkpoint.py``, with its protocol:

  * **atomic**: write to ``<dir>/.tmp-<step>`` then ``os.replace`` to
    ``<dir>/ckpt-<step:08d>``: a crash mid-write never corrupts the latest
    checkpoint, and a directory without ``meta.json`` is never listed;
  * **keep-K** retention with best-effort cleanup;
  * single-writer discipline: only the process with ``should_write``
    writes; every process restores;
  * **shape check** on restore: a leaf whose shape differs from the
    template's is refused.

A state is a dict whose values are ``nn.Module``s (their ``state_dict``),
:class:`~repro_torch.train.optimizer.AdamWState`s or dicts of tensors.
Format: one ``state.npz`` of the flattened state (keys are ``//``-joined
paths such as ``params//layers.0.attn.wq`` or ``opt//m//embed``) plus a
``meta.json`` with the step, the metadata and each key's torch dtype:
numpy has no bfloat16, so a bf16 tensor is stored as its int16 bits and
restored bit for bit. ``restore`` writes the values into the template
(a freshly initialised state) on the device the caller names.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

SEP = "//"
#: torch dtypes stored as the bits of a numpy integer type of their width
_BITS = {torch.bfloat16: torch.int16}


def _leaves(state: Any, prefix: str = ""):
    """(key, tensor) of every tensor of ``state`` in a fixed order."""
    if isinstance(state, torch.Tensor):
        yield prefix, state
    elif isinstance(state, nn.Module):
        for name, t in state.state_dict(keep_vars=True).items():
            yield prefix + SEP + name, t
    elif hasattr(state, "_fields"):                  # NamedTuple
        for f in state._fields:
            yield from _leaves(getattr(state, f), prefix + SEP + f)
    elif isinstance(state, dict):
        for k, v in state.items():
            yield from _leaves(v, f"{prefix}{SEP}{k}" if prefix else str(k))
    else:
        raise TypeError(f"cannot checkpoint {type(state).__name__} at "
                        f"{prefix!r}")


def _flatten(state: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """The state's tensors as host arrays by key, and each key's dtype."""
    arrays, dtypes = {}, {}
    for key, t in _leaves(state):
        t = t.detach()
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        if t.dtype in _BITS:
            t = t.view(_BITS[t.dtype])
        arrays[key] = t.cpu().numpy()
    return arrays, dtypes


@torch.no_grad()
def _unflatten_into(template: Any, arrays: Dict[str, np.ndarray],
                   dtypes: Dict[str, str], device=None) -> Any:
    """Write ``arrays`` into the tensors of ``template`` (in place, moved
    to ``device`` first when given) and return it. A missing key, or a
    shape or dtype that differs from the template's, raises."""
    if device is not None:
        template = _to_device(template, torch.device(device))
    for key, t in _leaves(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs model {tuple(t.shape)}")
        if dtypes[key] != str(t.dtype).removeprefix("torch."):
            raise ValueError(f"dtype mismatch for {key}: ckpt "
                             f"{dtypes[key]} vs model {t.dtype}")
        src = torch.from_numpy(np.array(arr, order="C"))   # keeps 0-d
        if t.dtype in _BITS:
            src = src.view(t.dtype)
        t.copy_(src)
    return template


def _to_device(state: Any, device: torch.device) -> Any:
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, nn.Module):
        return state.to(device)
    if hasattr(state, "_fields"):
        return type(state)(*(_to_device(getattr(state, f), device)
                             for f in state._fields))
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    raise TypeError(f"cannot move {type(state).__name__}")


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    should_write: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any,
             metadata: Optional[Dict] = None) -> str:
        if not self.should_write:
            return ""
        arrays, dtypes = _flatten(state)
        tmp = os.path.join(self.directory, f".tmp-{step}")
        final = os.path.join(self.directory, f"ckpt-{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        meta = {"step": step, "time": time.time(), "n_leaves": len(arrays),
                "dtypes": dtypes}
        meta.update(metadata or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        cks = self.list_steps()
        for step in cks[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory,
                                       f"ckpt-{step:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt-(\d{8})", name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, device=None) -> Any:
        """Load ``step`` into ``template`` (a state of the same structure,
        e.g. a fresh init) and return it, every tensor on ``device`` (by
        default where the template's tensors are)."""
        path = os.path.join(self.directory, f"ckpt-{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f)["dtypes"]
        with np.load(os.path.join(path, "state.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return _unflatten_into(template, arrays, dtypes, device)

    def restore_or_init(self, init_fn: Callable[[], Any], device=None
                        ) -> Tuple[Any, int]:
        """Restart-after-failure entry point: returns (state, start_step);
        the latest checkpoint written into ``init_fn()``'s state, or that
        state itself at step 0 when there is none."""
        step = self.latest_step()
        state = init_fn()
        if step is None:
            return state, 0
        return self.restore(step, state, device), step
