"""The port's detector trainer (ekaid_torch/train/train_detector.py) on
the CPU: the warmup-cosine schedule against optax's; three updates of
the trainer's AdamW with the global-norm clip against optax's chain on
the same gradients (per tensor ||port - optax|| / ||optax|| <= 1e-5, as
for the VQA optimizer), the first of them moving nothing; `fit`,
`validation_loss` and `evaluate`; the CLI, whose `.pt` the extraction
runner's `--ana_ckpt` reads. The reference's own `DetectorTrainer.fit`
runs in its own test (tests/test_detector.py); here the trainer is held
to the reference piece by piece (data: test_torch_det_data.py, the
step: test_torch_det_losses.py, schedule and optimizer here).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ekaid_torch.config import load_config
from ekaid_torch.extract import runner
from ekaid_torch.train import train_detector as ttd
from ekaid_torch.train.step import warmup_cosine

PARAM_RTOL = 1e-5
DET = dict(image_size=64, batch_size=4, fpn_channels=16, roi_feat_dim=32,
           pre_nms_topk=50, post_nms_topk=30)


def small_cfg(compute="float32"):
    cfg = load_config(overrides={"detector": DET})
    return cfg.replace(dtypes=cfg.dtypes.replace(compute_dtype=compute))


@pytest.mark.parametrize("lr,warmup,total", [
    (1e-3, 100, 1000), (1e-3, 100, 2), (3e-4, 5, 40), (2e-3, 100, 7)])
def test_warmup_cosine_matches_optax(lr, warmup, total):
    """Within 2 f32 ulps of optax at every count (XLA's f32 cosine is
    within an ulp of the correctly rounded one the port takes), 0 at
    count 0, and the trainer's warmup rule."""
    warmup = min(warmup, max(1, total // 10))
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total)
    mine = warmup_cosine(lr, warmup, total)
    counts = np.arange(total + 3)
    want = np.asarray(ref(jnp.asarray(counts)), np.float32)
    got = np.array([mine(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert mine(0) == 0.0 and float(ref(0)) == 0.0
    tr_warmup = min(100, max(1, total // 10))
    assert warmup == tr_warmup


def test_warmup_cosine_refuses_no_decay_steps():
    with pytest.raises(ValueError):
        warmup_cosine(1e-3, 1, 1)
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 1)


@pytest.fixture(scope="module")
def arrays():
    return ttd.synthetic_blob_dataset(8, 64, 3, seed=1)


def test_three_updates_match_optax_adamw_with_clip(arrays):
    """The trainer's first three updates against optax's
    chain(clip_by_global_norm(10), adamw(warmup_cosine, wd 1e-4)) fed the
    same gradients: the first update leaves every parameter bit-equal
    (lr 0 at count 0), the clip is active, and after three updates each
    tensor is within 1e-5 relative of optax's."""
    tr = ttd.DetectorTrainer(small_cfg(), 3, total_steps=4, lr=1e-3,
                             augment_data=False, device="cpu")
    names = tr.opt.names
    p0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    seen, norms = [], []
    step = tr.opt.step

    def spy(grads, grad_norm=None):
        seen.append({n: g.detach().numpy().copy()
                     for n, g in zip(names, grads)})
        norms.append(float(grad_norm))
        step(grads, grad_norm)

    tr.opt.step = spy
    batch = next(ttd.batches(arrays, 4, shuffle=False, seed=0))
    for i in range(3):
        tr.train_step(*tr._tensors(*batch), tr.draws(4, 0, i, 0))
        if i == 0:
            for n, p in tr.model.named_parameters():
                assert torch.equal(p, p0[n]), n
    assert max(norms) > ttd.GRAD_CLIP
    tx = optax.chain(optax.clip_by_global_norm(ttd.GRAD_CLIP),
                     optax.adamw(optax.warmup_cosine_decay_schedule(
                         0.0, 1e-3, tr.warmup, 4),
                         weight_decay=ttd.WEIGHT_DECAY))
    params = {n: jnp.asarray(p.numpy()) for n, p in p0.items()}
    state = tx.init(params)
    for g in seen:
        updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
    moved = 0
    for n, p in tr.model.named_parameters():
        want = np.asarray(params[n])
        err = np.linalg.norm(p.detach().numpy() - want) / max(
            np.linalg.norm(want), 1e-30)
        assert err <= PARAM_RTOL, f"{n}: {err}"
        moved += not np.array_equal(want, p0[n].numpy())
    assert moved == len(names)


def test_fit_validation_loss_and_evaluate(arrays):
    tr = ttd.DetectorTrainer(small_cfg(), 3, total_steps=3, lr=1e-3,
                             device="cpu")
    last = tr.fit(arrays, steps=3, log_every=1)
    assert set(last) == {"rpn_obj", "rpn_box", "roi_cls", "roi_box",
                         "total", "grad_norm"}
    assert all(np.isfinite(v) for v in last.values())
    assert tr.opt.count == 3 and len(tr.step_seconds) == 3
    assert len(tr.augment_seconds) == 3
    vl = tr.validation_loss(arrays)
    assert set(vl) == {"val_rpn_obj", "val_rpn_box", "val_roi_cls",
                       "val_roi_box", "val_total"}
    assert np.isfinite(vl["val_total"])
    scores = tr.evaluate(arrays, proposals=True)
    assert {"AP50", "AR", "AR@100"} <= set(scores)
    with pytest.raises(ValueError):
        tr.fit([a[:3] for a in arrays], steps=1)


def test_bf16_trainer_steps_finite(arrays):
    """f32 masters with bf16 compute, the flagship policy."""
    tr = ttd.DetectorTrainer(small_cfg("bfloat16"), 3, total_steps=4,
                             device="cpu")
    last = tr.fit(arrays, steps=2, log_every=1)
    assert all(np.isfinite(v) for v in last.values())
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())


def test_cli_writes_a_checkpoint_the_runner_reads(tmp_path, capsys):
    """`python -m ekaid_torch.train.train_detector` on the CPU: train,
    evaluate, write a .pt; `--init_ckpt` fine-tunes from it; the
    extraction runner's `--ana_ckpt` builds its anatomy detector from it
    and extracts."""
    from ekaid_torch.utils.orbax_import import load_detector
    cfg_path = tmp_path / "det.yaml"
    cfg_path.write_text(yaml.safe_dump({"detector": DET}))
    a, b = tmp_path / "a.pt", tmp_path / "b.pt"
    common = ["--cfg", str(cfg_path), "--synthetic", "8", "--device", "cpu"]
    scores = ttd.main(common + ["--steps", "2", "--ckpt_out", str(a)])
    assert "AP50" in scores
    assert "AP50:" in capsys.readouterr().out
    ttd.main(common + ["--steps", "2", "--init_ckpt", str(a),
                       "--ckpt_out", str(b), "--no_augment"])
    assert f"initialized from {a}" in capsys.readouterr().out
    sa, sb = torch.load(a), torch.load(b)
    assert sa.keys() == sb.keys()
    assert any(not torch.equal(sa[k], sb[k]) for k in sa)
    cfg = load_config(str(cfg_path))
    tr = ttd.DetectorTrainer(cfg, 26, total_steps=2, device="cpu", seed=3)
    tr.load_state_dict(load_detector(str(a)))
    for k, v in tr.state_dict().items():
        assert torch.equal(v, sa[k]), k
    assert tr.opt.count == 0
    ana, _ = runner.build_detectors(cfg, ana_params=sa, device="cpu")
    for k, v in ana.state_dict().items():          # cast for inference
        assert torch.equal(v, sa[k].to(v.dtype)), k
    out = tmp_path / "g.h5"
    runner.main(["--cfg", str(cfg_path), "--synthetic", "4", "--batch_size",
                 "2", "--device", "cpu", "--ana_ckpt", str(a),
                 "--allow_random", "--out", str(out)])
    import h5py
    with h5py.File(out, "r") as f:
        assert f["image_features"].shape[0] == 4


def test_cli_trains_the_disease_detector(tmp_path):
    """`--which disease`: the same code at K=22 (23 scores, 88 deltas),
    whose .pt the runner's --dis_ckpt reads."""
    cfg_path = tmp_path / "det.yaml"
    cfg_path.write_text(yaml.safe_dump({"detector": DET}))
    out = tmp_path / "dis.pt"
    ttd.main(["--cfg", str(cfg_path), "--synthetic", "8", "--steps", "2",
              "--which", "disease", "--device", "cpu", "--ckpt_out",
              str(out)])
    sd = torch.load(out)
    assert sd["box_head.cls_score.kernel"].shape[1] == 23
    assert sd["box_head.bbox_pred.kernel"].shape[1] == 88
    _, dis = runner.build_detectors(load_config(str(cfg_path)),
                                    dis_params=sd, device="cpu")
    assert dis.num_classes == 22


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttd.main(["--synthetic", "4", "--steps", "1", "--image_size", "64",
                  "--batch_size", "4"])
