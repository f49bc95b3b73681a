"""The port's optimizer (runtime/trainer.py::AMSGrad) against frtm_tpu's
make_optimizer chain (L2 decay added to the gradient, then optax's AMSGrad,
the learning rate injected per epoch), fed the same gradients; and where
torch.optim.Adam(amsgrad=True) parts from that chain."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from frtm_tpu.runtime.trainer import make_optimizer
from frtm_tpu_torch.runtime.trainer import AMSGrad


def _run_jax(p0, grads, lrs):
    tx = make_optimizer(lrs[0], 1e-5)
    params = {"a": jnp.asarray(p0[0]), "b": jnp.asarray(p0[1])}
    state = tx.init(params)
    out = []
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        updates, state = tx.update({"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])}, state, params)
        params = optax.apply_updates(params, updates)
        out.append([np.asarray(params["a"]), np.asarray(params["b"])])
    return out


def _run_port(p0, grads, lrs):
    params = [torch.tensor(p, requires_grad=True) for p in p0]
    opt = AMSGrad(params, 1e-5)
    out = []
    for g, lr in zip(grads, lrs):
        for p, gi in zip(params, g):
            p.grad = torch.tensor(gi)
        opt.step(lr)
        out.append([p.detach().numpy().copy() for p in params])
    return out, opt


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(0)
    p0 = [rng.randn(5, 7).astype(np.float32) * 0.1, rng.randn(13).astype(np.float32)]
    # gradients of shrinking and growing scale, some exactly zero (the case
    # where the maximum of the bias-corrected second moment holds on)
    grads = []
    for k in range(20):
        g = [rng.randn(*p.shape).astype(np.float32) * (0.5 ** (k % 7)) for p in p0]
        g[1][::3] = 0.0
        grads.append(g)
    lrs = [1e-3] * 10 + [1e-4] * 10           # a StepLR step after 10 epochs
    return p0, grads, lrs, _run_jax(p0, grads, lrs)


def test_amsgrad_matches_make_optimizer_over_20_steps(problem):
    p0, grads, lrs, want = problem
    got, opt = _run_port(p0, grads, lrs)
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f"step {step}")
    assert opt.count == 20


def test_torch_adam_amsgrad_parts_from_the_jax_chain(problem):
    """torch keeps the maximum of the raw second moment and divides by the
    current bias correction afterwards; optax takes the maximum of the
    bias-corrected moment. They agree at step 1 and part from step 2 on."""
    p0, grads, lrs, want = problem
    params = [torch.tensor(p, requires_grad=True) for p in p0]
    adam = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-5, amsgrad=True)
    gaps = []
    for g, w in zip(grads[:5], want[:5]):
        for p, gi in zip(params, g):
            p.grad = torch.tensor(gi)
        adam.step()
        gaps.append(max(float(np.abs(p.detach().numpy() - wi).max()) for p, wi in zip(params, w)))
    assert gaps[0] < 1e-7
    assert min(gaps[1:]) > 1e-5, gaps


def test_optimizer_state_round_trips(problem, tmp_path):
    p0, grads, lrs, want = problem
    _, opt = _run_port(p0, grads[:7], lrs[:7])
    torch.save(opt.state_dict(), tmp_path / "opt.pth")
    params = [torch.tensor(p, requires_grad=True) for p in want[6]]
    resumed = AMSGrad(params, 1e-5)
    resumed.load_state_dict(torch.load(tmp_path / "opt.pth", weights_only=True))
    assert resumed.count == 7
    for g, lr in zip(grads[7:], lrs[7:]):
        for p, gi in zip(params, g):
            p.grad = torch.tensor(gi)
        resumed.step(lr)
    for a, b in zip(params, want[-1]):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        AMSGrad(params[:1]).load_state_dict(opt.state_dict())
