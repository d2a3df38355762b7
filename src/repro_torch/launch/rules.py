"""Logical→mesh axis rule sets per workload kind (counterpart of
``repro/launch/rules.py``).

Each logical axis maps to an ordered list of candidate mesh axes; the
divisibility-aware resolver (:func:`repro_torch.distributed.sharding.
spec_for`) picks the first that fits, so e.g. an 8-kv-head cache on a
16-way ``"model"`` axis falls back to sequence sharding.  The tables
are the reference's, entry for entry; ``mesh`` is anything with an
``axis_names`` tuple (a :class:`~repro_torch.launch.mesh.ShardMesh`).
"""

from __future__ import annotations


def make_rules(mesh, kind: str) -> dict:
    multi = "pod" in mesh.axis_names
    data = ("pod", "data") if multi else "data"

    if kind == "datalog":
        # Batched multi-source query serving: the query batch is
        # embarrassingly parallel — shard it across the data axis; the
        # vertex axis stays replicated (each rank advances its slice of
        # sources over the whole graph).
        return {
            "query_batch": [data, "data"],
            "vertex": [None],
        }

    rules = {
        # --- parameters ---------------------------------------------------
        "vocab": ["model"],
        "embed": ["data"],            # FSDP dim (ZeRO-3 style)
        "heads": ["model"],
        "kv": ["model"],
        "mlp": ["model"],
        "expert": ["model"],
        "layers": None,
        "norm": None,
        # --- activations ----------------------------------------------------
        "batch": [data, "data", None],
        "seq": [None],
        "embed_act": [None],
        "heads_act": ["model"],
        "mlp_act": ["model"],
        "vocab_act": ["model"],
        # --- kv cache ---------------------------------------------------
        "cache_batch": [data, "data"],
        "cache_kv": ["model"],
        "cache_seq": [("data", "model"), "model", "data"],
    }
    return rules


CACHE_LOGICAL = {
    "k": ("layers", "cache_batch", "cache_seq", "cache_kv", None),
    "v": ("layers", "cache_batch", "cache_seq", "cache_kv", None),
    "pos": (None,),
}


def _ndim(leaf) -> int:
    if hasattr(leaf, "ndim"):
        return int(leaf.ndim)
    if hasattr(leaf, "shape"):
        return len(leaf.shape)
    return 0


def cache_spec_tree(cache_tree):
    """Logical axes for a cache tree (matches ``models.init_cache``): a
    dict of the same keys, each leaf a tuple of logical names.  A leaf
    is judged by the keys on its path, as the reference's
    ``tree_map_with_path`` does."""
    def spec_of(names, leaf):
        nd = _ndim(leaf)
        if "k" in names or "v" in names:
            return CACHE_LOGICAL["k"][:nd] if nd >= 4 else (None,) * nd
        if "state" in names:
            return ("layers", "cache_batch", "mlp")
        if "cross" in names:
            if nd >= 4:
                return ("layers", "cache_batch", "cache_seq", "cache_kv",
                        None)[:nd]
            return (None,) * nd
        return (None,) * nd

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, names + (i,))
                              for i, v in enumerate(node))
        return spec_of(names, node)
    return walk(cache_tree, ())


def batch_logical(name: str) -> tuple:
    if name in ("tokens", "labels"):
        return ("batch", "seq")
    if name in ("embeds", "enc_embeds"):
        return ("batch", "seq", "embed_act")
    raise KeyError(name)
