"""Shared helpers of the tests/test_torch_*.py twins: one tiny GPT-2 built
by the JAX reference and carried into the PyTorch port through the
weight bridge, so both sides compute the same function on the CPU."""
import numpy as np
import torch


def reference_tiny_model(seed):
    """(reference GPT2, its config, the port's GPT2 with the same weights,
    the port's config) — f32, dropout off, on the CPU."""
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt2 import GPT2, GPT2Config

    from paddle_tpu_torch.models.gpt2 import GPT2Config as TConfig
    from paddle_tpu_torch.models.gpt2 import from_reference_params

    paddle.seed(seed)
    cfg = GPT2Config.tiny()
    cfg.dropout = 0.0
    model = GPT2(cfg)
    model.eval()
    params, _ = model.functional_state()
    tcfg = TConfig.tiny()
    tcfg.dropout = 0.0
    port = from_reference_params(
        tcfg, {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    return model, cfg, port, tcfg


def t(a, dtype=None):
    """numpy -> CPU torch tensor (a copy; int32 stays int32)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def dense_greedy(port_params, cfg, prompt, n_new):
    """Plain full-recompute greedy decode of the port's weights: every
    step runs a causal forward over the whole sequence (no cache), so it
    shares no code with the paged engine."""
    import torch.nn.functional as F

    E, H = cfg.hidden_size, cfg.num_heads
    Dh = E // H
    p = port_params
    ids = list(int(x) for x in prompt)
    for _ in range(n_new):
        tk = torch.tensor(ids)
        S = len(ids)
        x = p["wte.weight"][tk] + p["wpe.weight"][:S]
        causal = torch.ones(S, S, dtype=torch.bool).tril()
        for i in range(cfg.num_layers):
            a = F.layer_norm(x, (E,), p[f"h.{i}.ln_1.weight"],
                             p[f"h.{i}.ln_1.bias"], cfg.layer_norm_epsilon)
            qkv = a @ p[f"h.{i}.qkv_proj.weight"] + p[f"h.{i}.qkv_proj.bias"]
            q, k, v = (u.reshape(S, H, Dh).transpose(0, 1)
                       for u in qkv.split(E, dim=-1))
            s = (q @ k.transpose(1, 2)) * Dh ** -0.5
            w = torch.softmax(s.masked_fill(~causal, -1e30), dim=-1)
            o = (w @ v).transpose(0, 1).reshape(S, E)
            x = x + o @ p[f"h.{i}.out_proj.weight"] \
                + p[f"h.{i}.out_proj.bias"]
            m = F.layer_norm(x, (E,), p[f"h.{i}.ln_2.weight"],
                             p[f"h.{i}.ln_2.bias"], cfg.layer_norm_epsilon)
            hdn = F.gelu(m @ p[f"h.{i}.fc1.weight"] + p[f"h.{i}.fc1.bias"],
                         approximate="tanh")
            x = x + hdn @ p[f"h.{i}.fc2.weight"] + p[f"h.{i}.fc2.bias"]
        xf = F.layer_norm(x[-1], (E,), p["ln_f.weight"], p["ln_f.bias"],
                          cfg.layer_norm_epsilon)
        ids.append(int(torch.argmax(xf @ p["wte.weight"].T)))
    return np.asarray(ids, np.int32)
