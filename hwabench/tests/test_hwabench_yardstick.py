"""The yardstick's counts against hand counts at small shapes."""
import pytest

from hwabench import yardstick
from hwabench.reference import granite


def test_flash_forward_and_backward_counts():
    # B1 S4 Hq2 Hkv1 D8: 10 live pairs, one product 2*1*2*8*10 = 320
    assert yardstick.flash_fwd_cost(1, 4, 2, 1, 8) == (640, 416)
    assert yardstick.flash_bwd_cost(1, 4, 2, 1, 8) == ((960, 576),
                                                       (1280, 576))


def test_paged_and_sync_counts():
    # two sequences holding 1 and 3 tokens, Hq2 Hkv1 D4, tables of 2
    assert yardstick.paged_cost([1, 3], 2, 1, 4, 2) == (128, 152)
    assert yardstick.wa_sync_cost(2, 10) == (50, 280)


def test_least_time_takes_the_larger_bound():
    assert yardstick.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


@pytest.mark.parametrize("experts, want", [(0, 184), (4, 296)])
def test_matmul_parameters(experts, want):
    s = dict(L=1, D=4, H=2, Kv=1, P=2, F=8, V=10, E=experts,
             k=2 if experts else 0)
    assert yardstick.train_matmul_param_count(s) == want


def test_matmul_parameters_of_the_dense_cell():
    cfg = {"hidden_size": 2048, "num_attention_heads": 32,
           "num_key_value_heads": 8, "intermediate_size": 8192,
           "num_hidden_layers": 8, "vocab_size": 49155, "rope_theta": 1e4}
    # 49155*2048 + 8 * (2*2048*2048 + 2*2048*512 + 3*2048*8192)
    assert yardstick.train_matmul_param_count(granite.sizes(cfg)) \
        == 587_208_704
