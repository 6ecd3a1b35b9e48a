"""The reference's followed routings: for a served position, the logits
under a route taken the other way are those of a whole forward pass with
that one route flipped (at that position alone, the earlier positions
unchanged)."""

import json

import pytest
import torch

from cb_support import SMOKE
from cellbench.reference.model import Reference
from cellbench.weights import ReferenceWeights


class Flipped(Reference):
    """The plain reference with one route flipped: position ``pos`` at
    layer ``layer``."""

    def __init__(self, cfg, weights, pos, layer):
        super().__init__(cfg, weights)
        self.pos, self.layer, self.calls = pos, layer, 0

    def ffn(self, x, p, flip=False):
        y = super().ffn(x, p, flip)
        if self.calls == self.layer:
            y[self.pos] = super().ffn(x[self.pos:self.pos + 1], p, flip=True)[0]
        self.calls += 1
        return y


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_a_followed_route_is_the_pass_with_that_route_flipped(layer):
    cfg = json.loads((SMOKE / "configs" / "mixtral-smoke.json").read_text())
    weights = ReferenceWeights(cfg, 20241019, torch.float32, "cpu")
    seq = torch.randint(0, cfg["vocab_size"], (24,), generator=torch.Generator().manual_seed(5))
    start, pos = 10, 17
    ref = Reference(cfg, weights, flip_margin=float("inf"))
    plain = ref.logits([seq], [start])[0]
    rows, alt = ref.alternatives[0]
    # every served row is followed at every layer, and in pairs of layers
    n_layers = cfg["num_hidden_layers"]
    assert len(rows) == (len(seq) - start) * (n_layers + n_layers * (n_layers - 1) // 2)
    want = Flipped(cfg, weights, pos, layer).logits([seq], [start])[0][pos - start]
    assert (plain[pos - start] - want).abs().max() > 1e-3       # the flip matters
    err = (alt[rows == pos - start] - want).abs().amax(dim=-1)
    assert err.min() < 1e-4, err
