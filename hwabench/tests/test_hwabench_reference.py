"""The plain reference against hand-worked cases: one HWA cycle on a
quadratic loss, a model with no layers, and the full forward against a
token-by-token decode through a cache written here."""
import math

import pytest
import torch
import torch.nn.functional as F

from hwabench import weights
from hwabench.reference import granite, hwa

RECIPE = {"K": 2, "H": 2, "I": 2, "lr": 0.1, "total_steps": 100,
          "momentum": 0.9, "weight_decay": 0.5}


def test_one_hwa_cycle_by_hand():
    # loss 0.5 (p - t_k)^2: replica k's gradient p - t_k, plus wd * p
    targets = [0.0, 2.0]
    seen = []

    def loss_fn(params, inputs, _):
        return 0.5 * (params[0] - inputs).square().sum()

    def batches(step):
        return [(torch.tensor(t), None) for t in targets]

    stored, wa = hwa.follow(
        loss_fn, [torch.tensor(1.0)], batches, RECIPE, 2,
        on_step=lambda s, k, loss, g: seen.append((s, k, float(g[0]))))
    lr1 = 0.1 * 0.5 * (1 + math.cos(math.pi / 100))
    # step 0: g = 1.5 and -0.5, p = 0.85 and 1.05; step 1: g = 1.275 and
    # -0.425, momenta 2.625 and -0.875
    p0 = 0.85 - lr1 * 2.625
    p1 = 1.05 + lr1 * 0.875
    assert [g for _, _, g in seen] == pytest.approx([1.5, -0.5, 1.275,
                                                     -0.425])
    mean = (p0 + p1) / 2
    assert [float(s[0]) for s in stored] == pytest.approx([mean, mean])
    assert float(wa[0]) == pytest.approx(mean)
    # the replicas as step 1 left them, W̿ after the sync of step 2
    kept, wa = hwa.follow(loss_fn, [torch.tensor(1.0)], batches, RECIPE, 2,
                          keep_at=1)
    assert [float(s[0]) for s in kept] == pytest.approx([0.85, 1.05])
    assert float(wa[0]) == pytest.approx(mean)


def _cfg(experts=0, layers=2):
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "intermediate_size": 16,
           "num_hidden_layers": layers, "vocab_size": 11,
           "rope_theta": 10000.0}
    if experts:
        cfg.update(num_local_experts=experts, num_experts_per_tok=2,
                   router_aux_loss_coef=0.01)
    return cfg


def _logits(cfg, p, tokens, start):
    """The reference's logits of one sequence from position ``start``
    on: its full forward, then the head."""
    with torch.no_grad():
        x, _ = granite.hidden(cfg, p, tokens[None])
    return x[0, start:] @ p["head"]


def _params(cfg, seed=3):
    tree = weights.make_params(granite.param_shapes(cfg), seed, "cpu")
    return weights.map_tree(lambda x: x.float(), tree)


def test_no_layers_by_hand():
    cfg = _cfg(layers=0)
    p = _params(cfg)
    tok = torch.tensor([4, 7])
    x = p["embed"][tok]
    want = x / torch.sqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        @ p["head"]
    assert torch.allclose(_logits(cfg, p, tok, 0), want, atol=1e-6)


def _rope(x, pos, theta=10000.0):
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = pos * freqs
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x1 * torch.sin(ang) + x2 * torch.cos(ang)], -1)


def _decode(cfg, p, tokens, n_prompt):
    """Prefill of the first ``n_prompt`` tokens one at a time, then a
    token at a time, each attending to the keys and values cached so
    far: logits at every position from ``n_prompt - 1``."""
    s = granite.sizes(cfg)
    D, H, Kv, P = s["D"], s["H"], s["Kv"], s["P"]
    cache = [([], []) for _ in range(s["L"])]

    def rms(x, w):
        return x / torch.sqrt(x.square().mean() + 1e-6) * w

    out = []
    for t, tok in enumerate(tokens.tolist()):
        x = p["embed"][tok]
        for n in range(s["L"]):
            lp = weights.map_tree(lambda a: a[n], p["stack"][0])
            h = rms(x, lp["ln1"]["scale"])
            q = _rope((h @ lp["attn"]["wq"].reshape(D, H * P)).view(H, P), t)
            k = _rope((h @ lp["attn"]["wk"].reshape(D, Kv * P)).view(Kv, P),
                      t)
            v = (h @ lp["attn"]["wv"].reshape(D, Kv * P)).view(Kv, P)
            cache[n][0].append(k)
            cache[n][1].append(v)
            K_, V_ = torch.stack(cache[n][0]), torch.stack(cache[n][1])
            heads = []
            for i in range(H):
                j = i // (H // Kv)
                w = torch.softmax(K_[:, j] @ q[i] / math.sqrt(P), 0)
                heads.append(w @ V_[:, j])
            x = x + torch.cat(heads) @ lp["attn"]["wo"].reshape(H * P, D)
            h = rms(x, lp["ln2"]["scale"])
            if "moe" in lp:
                m = lp["moe"]
                pr = torch.softmax(h @ m["router"], 0)
                top_p, top_i = torch.topk(pr, s["k"])
                top_p = top_p / top_p.sum()
                y = sum(w * ((F.silu(h @ m["w_gate"][e]) * (h @ m["w_up"][e]))
                             @ m["w_down"][e])
                        for w, e in zip(top_p, top_i.tolist()))
            else:
                m = lp["mlp"]
                y = (F.silu(h @ m["w_gate"]) * (h @ m["w_up"])) @ m["w_down"]
            x = x + y
        if t >= n_prompt - 1:
            out.append(rms(x, p["ln_f"]["scale"]) @ p["head"])
    return torch.stack(out)


@pytest.mark.parametrize("experts", [0, 4])
def test_full_forward_equals_a_token_by_token_decode(experts):
    cfg = _cfg(experts)
    p = _params(cfg)
    tokens = torch.tensor([1, 5, 9, 2, 2, 7, 3])
    want = _decode(cfg, p, tokens, 4)
    got = _logits(cfg, p, tokens, 3)
    assert got.shape == (4, 11)
    assert torch.allclose(got, want, atol=1e-5)


def test_control_rounds_to_float8():
    x = torch.tensor([1.0, 1.01, 448.0, -3.3])
    y = granite._F8.apply(x)
    assert float(y[2]) == 448.0 and float(y[0]) == 1.0
    assert float(y[1]) == 1.0          # e4m3 steps by 1/8 at 1
    assert y[3].item() != -3.3
