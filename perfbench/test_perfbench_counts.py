"""The benchmark's FLOP and byte counts against small cases worked by
hand: the decoder's (``models/decoder.py``) and the sync's
(``counts.transport_bytes``)."""

import pytest

from perfbench import counts, weights
from perfbench import manifest as mf
from perfbench.manifest import HERE

decoder = mf.model_module(HERE / "models" / "decoder.py")

DENSE = {"num_layers": 2, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 2, "vocab_size": 10, "ffn": "dense", "d_ff": 3,
         "dtype": "bfloat16", "tie_embeddings": True}
MOE = dict(DENSE, ffn="moe", moe={"num_experts": 4, "top_k": 2,
                                  "d_expert": 3, "num_shared_experts": 1})


def test_active_weights_of_a_dense_model():
    # head 10*4; a layer: q 4*4 + k, v 4*2 each + o 4*4 = 48; ffn 3*4*3 = 36
    assert decoder.active_matmul_params(DENSE) == 40 + 2 * (48 + 36)


def test_active_weights_of_a_moe_model():
    # a layer's FFN: (top-2 + 1 shared) * 3 * 4 * 3 = 108, router 4 * 4
    assert decoder.active_matmul_params(MOE) == 40 + 2 * (48 + 108 + 16)


def test_step_flops():
    # 6 * 208 weights * (3 rows * 5 tokens) + attention 6*3*2*2*5^2 a layer
    assert decoder.step_flops(DENSE, 3, 5) == 6 * 208 * 15 + 2 * 1800


def test_transport_bytes_of_a_one_rank_sync():
    specs = decoder.leaf_specs(DENSE)
    E = weights.n_elements(specs)
    leaves = len(specs)
    assert leaves == 11
    # read 4 bytes an element and write half a byte, one 4-byte scale a
    # leaf; then the reverse
    assert counts.transport_bytes(specs, 4) == 2 * (4 * E + E / 2 + 44)


@pytest.mark.parametrize("config", [DENSE, MOE])
def test_every_leaf_is_counted_once(config):
    import math

    specs = decoder.leaf_specs(config)
    assert weights.n_elements(specs) == sum(math.prod(s) for s, _, _ in
                                            specs.values())


def test_an_untied_head_is_a_leaf_of_its_own_and_one_product():
    untied = dict(DENSE, tie_embeddings=False)
    specs = decoder.leaf_specs(untied)
    assert specs[("lm_head",)][0] == (4, 10)
    assert weights.n_elements(specs) == weights.n_elements(
        decoder.leaf_specs(DENSE)) + 40
    # the lookup is no product: the head's 10 * 4 weights count once
    assert decoder.active_matmul_params(untied) == \
        decoder.active_matmul_params(DENSE)


def test_the_published_configurations_count_as_predicted():
    import json

    ds = json.load(open(HERE / "configs/deepseek-moe-16b-2l.json"))
    assert decoder.active_matmul_params(ds) == 381_943_808
    # 1,385,441,280 with the head tied, and its 102,400 x 2048 beside
    assert weights.n_elements(decoder.leaf_specs(ds)) == 1_595_156_480
    # 6 * 381,943,808 * 4,096 + 6 * 16 * 128 * 4096^2 * 2 layers
    assert decoder.step_flops(ds, 1, 4096) == 9_798_967_885_824


def test_the_one_chip_cell_s_counts_are_the_parent_s():
    """What ``dp1.deepseek-moe-16b-2l.int4ef`` reads, as the harness takes
    it from the cell (``counts.of_cell``): the step's FLOPs (``step_mfu``),
    the sync's bytes (``transport_roofline``) and the tree, as the counts
    read before they moved into the model file."""
    cell = mf.load_cell("dp1.deepseek-moe-16b-2l.int4ef")
    assert cell.model_path == HERE / "models" / "decoder.py"
    assert counts.of_cell(cell) == {"flops": 9_798_967_885_824,
                                    "transport_bytes": 14_356_408_448}
    assert cell.model.active_matmul_params(cell.config) == 381_943_808
    assert len(cell.specs) == 16
    assert weights.n_elements(cell.specs) == 1_595_156_480
