"""ekaid_torch caption metrics, answer accuracy and the device eval cache
against the JAX package, on captions and data made here."""

import numpy as np
import pytest
import torch

from _torch_port import port_cfg, tiny_cfg
from ekaid_tpu.data import device_cache as jcache
from ekaid_tpu.data import pipeline as jp
from ekaid_tpu.metrics import caption as jcap
from ekaid_tpu.metrics import coco as jcoco
from ekaid_tpu.train import score as jscore
from ekaid_torch.data import device_cache as pcache
from ekaid_torch.data import pipeline as pp
from ekaid_torch.metrics import caption as pcap
from ekaid_torch.metrics import coco as pcoco
from ekaid_torch.train import score as pscore

GTS = [
    ("0", "what has changed compared to the main image?",
     "the main image has an additional finding of pleural effusion"),
    ("0", "", "pleural effusion is new in the main image"),
    ("1", "is there any abnormality?", "yes"),
    ("2", "is the heart enlarged?", "no"),
    ("3", "where is the opacity?", "left lower lung zone"),
    ("4", "what level is the atelectasis?", "mild to moderate atelectasis"),
    ("5", "what abnormalities are seen?",
     "cardiomegaly, edema and hilar congestion"),
    ("6", "is there a pneumothorax?", "no"),
]
RES = {"0": "the main image has an additional finding of effusion",
       "1": "yes", "2": "yes", "3": "left lower lung",
       "4": "moderate atelectasis", "5": "cardiomegaly and edema",
       "6": "no"}


def _coco(mod, with_question=True):
    anns = [{"image_id": i, "id": f"{i}-{n}", "caption": c,
             **({"question": q} if with_question else {})}
            for n, (i, q, c) in enumerate(GTS)]
    res = [{"image_id": k, "caption": v} for k, v in RES.items()]
    gt = mod.CocoCaptions(annotations={"annotations": anns})
    return gt, gt.load_res(res), {"annotations": anns}, res


@pytest.mark.parametrize("vocab", [None, ["area", "region", "also", "too",
                                          "left", "lung"]])
def test_caption_evaluator_equals_jax(vocab):
    gt_p, res_p, _, _ = _coco(pcoco)
    gt_j, res_j, _, _ = _coco(jcoco)
    ev_p = pcoco.CaptionEvaluator(gt_p, res_p, vocab=vocab)
    ev_j = jcoco.CaptionEvaluator(gt_j, res_j, vocab=vocab)
    got, want = ev_p.evaluate(), ev_j.evaluate()
    assert list(got) == list(want) == list(pcoco.CaptionEvaluator.METRICS)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k
    assert 0.0 < got["Bleu_1"] < 1.0 and got["CIDEr"] > 0.0
    for img, scores in ev_j.img_to_eval.items():
        for k, v in scores.items():
            assert ev_p.img_to_eval[img][k] == pytest.approx(v, rel=1e-12), \
                (img, k)


def test_metric_functions_equal_jax():
    gts = {i: [pcap.ptb_tokenize(c) for j, _, c in GTS if j == i]
           for i in RES}
    res = {i: pcap.ptb_tokenize(c) for i, c in RES.items()}
    assert pcap.ptb_tokenize("Hello, (World)!") == \
        jcap.ptb_tokenize("Hello, (World)!")
    for fn in ("bleu", "rouge_l", "cider", "meteor15", "meteor_lite"):
        got, want = getattr(pcap, fn)(gts, res), getattr(jcap, fn)(gts, res)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                                   rtol=1e-12, err_msg=fn)
    para = [("lower lung", "lung base"), ("mild to moderate", "moderate")]
    assert pcap.meteor15(gts, res, paraphrases=para) == \
        pytest.approx(jcap.meteor15(gts, res, paraphrases=para), rel=1e-12)


def test_accuracy_equals_jax():
    _, _, gt, res = _coco(pcoco)
    got = pscore.accuracy(gt, res, verbose=False)
    assert got == pytest.approx(jscore.accuracy(gt, res, verbose=False))
    assert got[2] == pytest.approx(2 / 3)       # yes, yes (wrong), no
    _, _, gt2, _ = _coco(pcoco, with_question=False)
    assert pscore.accuracy(gt2, res, verbose=False) == pytest.approx(
        jscore.accuracy(gt2, res, verbose=False))


def _cache_cfg():
    cfg = tiny_cfg()
    return cfg.replace(data=cfg.data.replace(
        test=cfg.data.test.replace(batch_size=4)))


def test_device_cache_equals_jax_lru():
    """The same batches through both caches at a capacity that evicts:
    the same slots, hits, misses and upload bytes, and gathered batches
    equal to the compact wire's."""
    import jax.numpy as jnp
    cfg = _cache_cfg()
    jds = jp.synthetic_dataset(cfg, "train", n_pairs=40)
    pds = pp.synthetic_dataset(port_cfg(cfg), "train", n_pairs=40)
    jc = jcache.DeviceEvalCache(jds, capacity=10)
    pc = pcache.DeviceEvalCache(pds, capacity=10, device="cpu")
    order = np.random.default_rng(0).permutation(pds.split_idxs)
    batches = [order[i:i + 4] for i in range(0, 28, 4)] + [order[:4]]
    for idxs in batches:
        jd, jq = jc.ensure(idxs)
        pd, pq = pc.ensure(idxs)
        np.testing.assert_array_equal(pd.numpy(), jd)
        np.testing.assert_array_equal(pq.numpy(), jq)
        assert pc.stats() == jc.stats()
        wire = pp.compact_wire(pds.sample_batch(idxs))
        got = pc.gather_batch(pc.dev_arrays(), pd, pq,
                              torch.as_tensor(wire["question"]))
        want = jcache.DeviceEvalCache.gather_batch(
            jc.dev_arrays(), jnp.asarray(jd), jnp.asarray(jq),
            jnp.asarray(wire["question"]))
        for k, v in got.items():
            assert v.numpy().dtype == wire[k].dtype, k
            np.testing.assert_array_equal(v.numpy(), wire[k], err_msg=k)
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    assert pc.stats()["hits"] > 0 and pc.stats()["misses"] > 10
    with pytest.raises(ValueError, match="capacity"):
        pcache.DeviceEvalCache(pds, capacity=3, device="cpu").ensure(
            order[:4])
