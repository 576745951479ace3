"""Checkpoint/restart (fault tolerance).

The port of the JAX package's ``training/checkpoint.py``, in the same
format: a state tree is flattened to ``path -> ndarray`` and written to
``step_<N>.npz`` beside a JSON manifest with a content checksum; writes go
to a temporary file + ``os.replace``, so a crash mid-save never corrupts
the latest checkpoint.  ``restore_latest`` skips corrupt or partial
checkpoints (checked against the manifest's checksum) and falls back to the
newest valid one.

Tensors are saved through numpy (bfloat16 as float32, which holds it
exactly) and restored as tensors on the template leaf's device and in its
dtype; other leaves (the data cursor's ints) come back as CPU tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Optional

import numpy as np
import torch


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten_into(template, flat):
    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(vals)
        arr = torch.from_numpy(np.array(flat[prefix[:-1]]))
        if isinstance(tree, torch.Tensor):
            return arr.to(device=tree.device, dtype=tree.dtype)
        return arr

    return rebuild(template)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, state, step: int, extra: Optional[dict] = None):
        flat = _flatten(state)
        payload_path = os.path.join(self.dir, f"step_{step:08d}.npz")
        tmp = payload_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        digest = _file_checksum(tmp)
        os.replace(tmp, payload_path)
        manifest = {
            "step": step,
            "checksum": digest,
            "keys": sorted(flat.keys()),
            "extra": extra or {},
        }
        mpath = os.path.join(self.dir, f"step_{step:08d}.json")
        mtmp = mpath + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, mpath)
        self._gc()
        return payload_path

    # -- restore ------------------------------------------------------------
    def steps(self):
        out = []
        for fn in os.listdir(self.dir):
            m = re.match(r"step_(\d+)\.json$", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def is_valid(self, step: int) -> bool:
        mpath = os.path.join(self.dir, f"step_{step:08d}.json")
        ppath = os.path.join(self.dir, f"step_{step:08d}.npz")
        if not (os.path.exists(mpath) and os.path.exists(ppath)):
            return False
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            return _file_checksum(ppath) == manifest["checksum"]
        except (OSError, ValueError, KeyError):
            return False

    def restore(self, template, step: int):
        ppath = os.path.join(self.dir, f"step_{step:08d}.npz")
        with np.load(ppath) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(template, flat)

    def restore_latest(self, template):
        """Newest *valid* checkpoint (corrupt ones are skipped) or None."""
        for step in reversed(self.steps()):
            if self.is_valid(step):
                return self.restore(template, step), step
        return None, 0

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}.json")) as f:
            return json.load(f)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"step_{s:08d}{ext}"))
                except OSError:
                    pass


def _file_checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
