"""Map checkpoint and resume (PyTorch).

Counterpart of ``ccm_slam_tpu/io/checkpoint.py`` (the reference's cereal
archives, ``Map::SaveMap``/``LoadMap``, cslam/src/Map.cpp:335-386, 414-621;
the ``ccmslam_savemap`` service): a whole ``MapState`` is one compressed
``.npz`` whose keys are the JAX package's path flattening (``kfs/<field>``,
``mps/<field>``, ``next_kf``, ``next_mp``, ``insert_counter``), so each
package reads the other's files; ``save_pytree`` writes any tree of tensors
(a ``Vocabulary``, ...) the same way.  Loading casts every array to the empty
arena's dtype, as the reference does.

``remap_to_client`` is the reference's load-time id policy: every loaded
entity belongs to client 0, ids renumbered densely (Map.cpp:527-541).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models import map_store as ms
from ..ops import bow
from ..ops.bow import Vocabulary

_CURSORS = ("next_kf", "next_mp", "insert_counter")


def _flatten(tree, path=()) -> dict:
    """{npz key: leaf} of a tree of dataclasses, dicts, tuples and lists
    (``None`` an empty subtree), keyed as the reference's path flattening:
    field names, sequence positions and ``['key']`` for dict keys, joined
    by '/'."""
    if tree is None:
        return {}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {"/".join(map(str, path)): tree}
    out = {}
    for name, sub in items:
        out.update(_flatten(sub, path + (name,)))
    return out


def _host(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Any tree of tensors (a ``MapState``, a ``Vocabulary``, ...) as one
    compressed ``.npz`` with the reference's keys."""
    np.savez_compressed(path, **{k: _host(v) for k, v in _flatten(tree).items()})


def save_map(path: str, m: ms.MapState) -> None:
    save_pytree(path, m)


def load_map(path: str, device=None) -> ms.MapState:
    """A saved map (either package's) on ``device`` (the card unless told
    otherwise), each field cast to the empty arena's dtype."""
    dev = resolve_device(device)
    data = np.load(path)
    K, N = data["kfs/xy"].shape[:2]
    M, O = data["mps/obs_kf"].shape
    empty = ms.empty_map(K, M, N, O, "cpu")

    def load(key, like):
        return torch.as_tensor(np.asarray(data[key])).to(like.dtype).to(dev)

    stores = {}
    for store in ("kfs", "mps"):
        obj = getattr(empty, store)
        stores[store] = obj.replace(**{f.name: load(f"{store}/{f.name}", getattr(obj, f.name))
                                       for f in dataclasses.fields(obj)})
    return ms.MapState(**stores, **{n: load(n, getattr(empty, n)) for n in _CURSORS})


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    bow.save_vocabulary(path, vocab)


def load_vocabulary(path: str, device=None) -> Vocabulary:
    return bow.load_vocabulary(path, device)


def remap_to_client(m: ms.MapState, client_id: int = 0) -> ms.MapState:
    """Reference load policy: the map compacted, every entity owned by
    ``client_id`` and ids renumbered densely by arena slot."""
    m = ms.compact_map(m)
    kfs, mps = m.kfs, m.mps
    dev = kfs.kf_id.device
    ar_kf = torch.arange(kfs.capacity, dtype=torch.int32, device=dev)
    ar_mp = torch.arange(mps.capacity, dtype=torch.int32, device=dev)
    cid = torch.tensor(client_id, dtype=torch.int32, device=dev)
    return m.replace(
        kfs=kfs.replace(kf_id=torch.where(kfs.valid, ar_kf, -1),
                        client_id=torch.where(kfs.valid, cid, kfs.client_id)),
        mps=mps.replace(mp_id=torch.where(mps.valid, ar_mp, -1),
                        client_id=torch.where(mps.valid, cid, mps.client_id)),
    )
