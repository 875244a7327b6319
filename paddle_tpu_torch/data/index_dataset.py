"""Tree index for retrieval models: the port's own copy of
``paddle_tpu.data.index_dataset`` (reference
``paddle/fluid/distributed/index_dataset/``: ``index_wrapper`` TreeIndex,
``index_sampler`` LayerWiseSampler).

TDM (tree-based deep match) builds a K-ary tree over items: every item is
a leaf; training samples positives along the item's root→leaf path and
negatives uniformly from the same layers. Both stay on the host (index
construction and sampling are pointer-chasing); the sampler's outputs are
fixed-shape arrays for the train step. The numpy calls and their order are
the JAX module's, so the same seed gives the same samples bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.enforce import NotFoundError, enforce

__all__ = ["TreeIndex", "LayerWiseSampler"]


class TreeIndex:
    """K-ary item tree (index_wrapper.h TreeIndex).

    Nodes are numbered breadth-first from 0 (the root); child c of node n
    is ``n*k + 1 + c``. Items occupy the deepest layer's first leaves in
    the given order."""

    def __init__(self, item_ids: Sequence[int], branch: int = 2) -> None:
        enforce(branch >= 2, "branch factor >= 2")
        enforce(len(item_ids) > 0, "need at least one item")
        self.branch = branch
        self.item_ids = np.asarray(list(item_ids), np.int64)
        n = len(self.item_ids)
        # depth so the deepest layer holds >= n leaves
        self.height = 1
        while branch ** self.height < n:
            self.height += 1
        first_leaf = (branch ** self.height - 1) // (branch - 1)
        self._leaf_codes = first_leaf + np.arange(n, dtype=np.int64)
        self._item_to_code: Dict[int, int] = {
            int(i): int(c) for i, c in zip(self.item_ids, self._leaf_codes)}
        self._code_to_item: Dict[int, int] = {
            int(c): int(i) for i, c in zip(self.item_ids, self._leaf_codes)}

    def total_node_num(self) -> int:
        return int(self._leaf_codes[-1]) + 1

    def emb_size(self) -> int:  # the reference's name for the node count
        return self.total_node_num()

    def get_ancestor(self, code: int, level_up: int) -> int:
        for _ in range(level_up):
            code = (code - 1) // self.branch
        return code

    def get_travel_codes(self, item_id: int) -> np.ndarray:
        """An item's path codes, leaf first, root last (the reference's
        order)."""
        code = self._item_to_code.get(int(item_id))
        if code is None:
            raise NotFoundError(f"item {item_id} not in tree")
        path = []
        while True:
            path.append(code)
            if code == 0:
                break
            code = (code - 1) // self.branch
        return np.asarray(path, np.int64)

    def get_layer_codes(self, level: int) -> np.ndarray:
        """All codes of a layer (0 = root); the deepest layer holds only
        the items' leaves."""
        enforce(0 <= level <= self.height, f"level in [0,{self.height}]")
        first = (self.branch ** level - 1) // (self.branch - 1)
        count = self.branch ** level
        if level == self.height:
            return self._leaf_codes.copy()
        return first + np.arange(count, dtype=np.int64)

    def get_items_of_codes(self, codes: Sequence[int]) -> List[Optional[int]]:
        return [self._code_to_item.get(int(c)) for c in codes]


class LayerWiseSampler:
    """index_sampler.h LayerWiseSampler: for each target item, per sampled
    layer, the positive ancestor of that layer and ``layer_counts[l]``
    uniform negatives from the same layer (the positive excluded)."""

    def __init__(self, tree: TreeIndex, layer_counts: Sequence[int],
                 seed: int = 0, start_sample_layer: int = 1) -> None:
        enforce(len(layer_counts) == tree.height - start_sample_layer + 1,
                f"need one negative-count per sampled layer "
                f"({tree.height - start_sample_layer + 1})")
        self.tree = tree
        self.layer_counts = [int(c) for c in layer_counts]
        self.start_layer = int(start_sample_layer)
        self._rng = np.random.default_rng(seed)

    def sample(self, item_ids: Sequence[int]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (pair_index, codes, labels), each 1-D of equal length: one
        positive (label 1) and the negatives (label 0) per layer per item."""
        idx_out: List[int] = []
        codes_out: List[int] = []
        labels_out: List[int] = []
        for pi, item in enumerate(item_ids):
            path = self.tree.get_travel_codes(item)  # leaf → root
            for li, layer in enumerate(range(self.start_layer, self.tree.height + 1)):
                pos = path[self.tree.height - layer]
                layer_codes = self.tree.get_layer_codes(layer)
                idx_out.append(pi)
                codes_out.append(int(pos))
                labels_out.append(1)
                negs_wanted = self.layer_counts[li]
                cand = layer_codes[layer_codes != pos]
                if len(cand) and negs_wanted:
                    k = min(negs_wanted, len(cand))
                    for c in self._rng.choice(cand, size=k, replace=False):
                        idx_out.append(pi)
                        codes_out.append(int(c))
                        labels_out.append(0)
        return (np.asarray(idx_out, np.int64),
                np.asarray(codes_out, np.int64),
                np.asarray(labels_out, np.int64))
