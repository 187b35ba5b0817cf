"""A run with the timed path broken underneath comes out not correct:
once for each fault its cell can have.  The faults are planted in the
port (the harness runs as it always does); the check on the card is not
needed to see them, so the runs are the CPU's at a small size."""
import pytest

from conftest import run_small, small_cell


def unchanged_estimate(monkeypatch):
    """Every refinement step returns its state unchanged."""
    from sdfest_torch.pipeline.pipeline import SDFPipeline

    monkeypatch.setattr(SDFPipeline, "_make_adam",
                        lambda self: lambda params, grads, moments, count:
                        (dict(params), moments))


def altered_answer(monkeypatch):
    """The estimate's position is moved by a millimetre where it is
    returned."""
    from sdfest_torch.pipeline.pipeline import SDFPipeline

    call = SDFPipeline.__call__

    def moved(self, *args, **kwargs):
        position, *rest = call(self, *args, **kwargs)
        return (position + 1e-3, *rest)

    monkeypatch.setattr(SDFPipeline, "__call__", moved)


def half_the_hypotheses(monkeypatch):
    """The losses of the batch's second half are left out and the first
    half's doubled (the mean over the rest)."""
    from sdfest_torch.pipeline import losses

    for name in ("depth_l1_loss", "masked_mean_abs"):
        fn = getattr(losses, name)

        def halved(*args, _fn=fn):
            out = _fn(*args)
            b = out.shape[0]
            w = out.new_zeros(b)
            w[: b // 2] = b / (b // 2)
            return out * w

        monkeypatch.setattr(losses, name, halved)


def unchanged_training(monkeypatch):
    """Adam's update leaves the parameters as they were."""
    from sdfest_torch.training import optim

    monkeypatch.setattr(optim.Adam, "update", lambda self, grads: None)


def half_the_batch(monkeypatch):
    """The VAE loss is taken over the batch's first half, times two."""
    from sdfest_torch.training.vae_trainer import VAETrainer

    loss = VAETrainer.loss

    def halved(self, x, iteration, eps=None, quats=None, **kw):
        h = x.shape[0] // 2
        total, metrics = loss(self, x[:h], iteration, eps=eps[:h],
                              quats=quats[:h], **kw)
        return total * 2, {k: v * 2 for k, v in metrics.items()}

    monkeypatch.setattr(VAETrainer, "loss", halved)


@pytest.mark.parametrize("name,fault", [
    ("mug_procedural.frames", unchanged_estimate),
    ("mug_procedural.frames", altered_answer),
    ("bowl_procedural.fast", unchanged_estimate),
    ("bowl_procedural.fast", altered_answer),
    ("mug_procedural.hyp8", unchanged_estimate),
    ("mug_procedural.hyp8", half_the_hypotheses),
    ("mug_procedural.vae_train", unchanged_training),
    ("mug_procedural.vae_train", half_the_batch),
])
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = run_small(small_cell(name))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
