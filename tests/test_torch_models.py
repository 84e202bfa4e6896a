"""CPU twins of the NLP half of `test_models.py` that no other twin
holds: GPT-2 tiny trained by the eager AdamW optimizer over the module's
parameters (six steps, the loss falling) and the eval forward's logits,
both on the reference's weights (carried through the weight bridge,
`tests/torch_twin_util.py`) and against the reference model's numbers.
The other NLP cases have twins already: BERT tiny's MLM loss and
gradients and ErnieConfig.large (`test_torch_bert.py`), the functional
GPT-2 train step (`test_torch_train.py`). `TestHeadMatmulLayout`
inspects JAX's lowered module and has no counterpart in the port.

Tolerances: losses and logits rtol 1e-4, atol 1e-4 (float32 through
two layers, six optimizer steps).
"""
import numpy as np
import torch

import paddle_tpu as paddle

from torch_twin_util import reference_tiny_model

torch.set_num_threads(1)


def test_gpt2_tiny_loss_decreases_as_the_reference():
    import paddle_tpu.optimizer as ropt

    import paddle_tpu_torch.optimizer as popt

    model, cfg, port, _tcfg = reference_tiny_model(0)
    model.train()
    port.train()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32)) \
        .astype(np.int32)
    r_opt = ropt.AdamW(1e-3, parameters=model.parameters())
    p_opt = popt.AdamW(1e-3, parameters=port.parameters(), device="cpu")
    losses = []
    for _ in range(6):
        rl = model.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        pl = port.loss(torch.from_numpy(ids), torch.from_numpy(ids))
        for loss, opt in ((rl, r_opt), (pl, p_opt)):
            loss.backward()
            opt.step()
            opt.clear_grad()
        losses.append((float(pl), float(rl.numpy())))
    got, want = zip(*losses)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


def test_gpt2_kv_generation_path_logits():
    model, cfg, port, _tcfg = reference_tiny_model(1)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 8)) \
        .astype(np.int32)
    want = np.asarray(model(paddle.to_tensor(ids))._value)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    assert list(got.shape) == [1, 8, cfg.vocab_size]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
