"""The positional index's lifecycle in the port: the six contracts of
``tests/test_positional_lifecycle.py`` run through the port's catalog
(dump round trip, BM25 norm lengths, a dump without positions, optimize
with mutations, optimize parity with the text path, optimize without
texts), and a dump written by the JAX package restored by the port with
its positional index, whose answers equal the JAX package's."""

import numpy as np

from mygramdb_tpu.catalog import TableCatalog as JCatalog
from mygramdb_tpu.storage import dump as jdump
from mygramdb_tpu_torch.catalog import TableCatalog
from mygramdb_tpu_torch.config import load_config_from_dict
from mygramdb_tpu_torch.query import QueryParser
from mygramdb_tpu_torch.query.pipeline import SearchPipeline
from mygramdb_tpu_torch.storage import dump as dump_format
from mygramdb_tpu_torch.utils import textproc

from test_positional_lifecycle import CFG, TEXTS
from torch_parity import torch_cpu  # noqa: F401

P = QueryParser()


def make_ctx(catalog_cls=TableCatalog):
    cfg = load_config_from_dict(CFG)
    ctx = catalog_cls(cfg).resolve("articles")
    bulk = ctx.begin_bulk_load()
    bulk.add_batch([(str(i), t, {"status": i % 3})
                    for i, t in enumerate(TEXTS, start=1)])
    bulk.finish()
    ctx._rebuild_device_text()
    return ctx, cfg


def run(ctx, cfg, line):
    out = SearchPipeline(ctx, cfg).execute(P.parse(line))
    assert out.success, out.error
    pks = [out.sn.doc_store.primary_key(int(d)) for d in out.results]
    return out, pks


def restore(cfg, ts):
    ctx = TableCatalog(cfg).resolve("articles")
    ctx.restore_from_state(ts)
    return ctx


def positional_ids(ctx, term):
    """(total, ids) of the positional engine for one covered term."""
    dev = ctx.index.device
    built = ctx.index.built
    pairs, covered = textproc.query_gram_offsets(
        ctx.normalize(term), 2, 1, True)
    assert covered
    plan = dev.plan_positional([(built.term_dict.get(g), o)
                                for g, o in pairs])
    total, ids, _s, _p = dev.search_verified_positional(plan, 128, True)
    return total, sorted(int(x) for x in ids if x >= 0)


def test_dump_roundtrip_preserves_positional(torch_cpu, tmp_path):
    ctx, cfg = make_ctx()
    assert ctx.index.device.positional is not None
    out0, pks0 = run(ctx, cfg, "SEARCH articles 日本 LIMIT 10")
    assert out0.debug.optimization_used == "device_topn"
    path = str(tmp_path / "pos.dump")
    dump_format.save_dump(path, {"cfg": 1}, [ctx.table_state()])
    _info, tables = dump_format.load_dump(path)
    assert tables[0].positional_state is not None
    ctx2 = restore(cfg, tables[0])
    assert ctx2.index.device.positional is not None, \
        "restore dropped the positional index"
    out1, pks1 = run(ctx2, cfg, "SEARCH articles 日本 LIMIT 10")
    assert out1.debug.optimization_used == "device_topn"
    assert out1.total == out0.total and set(pks1) == set(pks0)
    assert positional_ids(ctx2, "日本") == positional_ids(ctx, "日本")


def test_dump_roundtrip_preserves_bm25_norm_lengths(torch_cpu, tmp_path):
    ctx, cfg = make_ctx()
    out0, _ = run(ctx, cfg, "SEARCH articles quick SORT _score DESC LIMIT 5")
    assert out0.scores is not None
    path = str(tmp_path / "pos.dump")
    dump_format.save_dump(path, {"cfg": 1}, [ctx.table_state()])
    _info, tables = dump_format.load_dump(path)
    ctx2 = restore(cfg, tables[0])
    dl = ctx2.index.device.positional.doc_len.numpy()
    assert dl[1] == len(TEXTS[0]), "doc lengths not re-attached on restore"
    out1, _ = run(ctx2, cfg, "SEARCH articles quick SORT _score DESC LIMIT 5")
    np.testing.assert_allclose(out1.scores, out0.scores, rtol=1e-5)


def test_legacy_dump_without_positional_still_restores(torch_cpu, tmp_path):
    ctx, cfg = make_ctx()
    ts = ctx.table_state()
    ts.positional_state = None  # a dump from before positions
    path = str(tmp_path / "legacy.dump")
    dump_format.save_dump(path, {"cfg": 1}, [ts])
    _info, tables = dump_format.load_dump(path)
    assert tables[0].positional_state is None
    ctx2 = restore(cfg, tables[0])
    assert ctx2.index.device.positional is None
    out, pks = run(ctx2, cfg, "SEARCH articles 日本 LIMIT 10")
    assert out.debug.optimization_used == "device_topn"
    assert out.total == 3


def test_optimize_rebuilds_positional_with_mutations(torch_cpu):
    ctx, cfg = make_ctx()
    gen0 = ctx.index.built_generation
    ctx.add_row("100", "大阪城と京都の金閣寺", {"status": 1})
    ctx.update_row("2", "quick silver 東京 update")
    ctx.remove_row("5")
    ctx.optimize()
    assert ctx.index.built_generation > gen0
    assert len(ctx.index.delta) == 0
    pp = ctx.index.device.positional
    assert pp is not None, "optimize dropped the positional index"
    out, pks = run(ctx, cfg, "SEARCH articles 東京 LIMIT 10")
    assert out.debug.optimization_used == "device_topn"
    assert set(pks) == {"2", "4"}
    _out2, pks2 = run(ctx, cfg, "SEARCH articles 金閣寺 LIMIT 10")
    assert set(pks2) == {"100"}
    _out3, pks3 = run(ctx, cfg, "SEARCH articles brown LIMIT 10")
    assert set(pks3) == {"1"}
    dl = pp.doc_len.numpy()
    new_id = ctx.doc_store.doc_id("100")
    assert dl[new_id] == len(ctx.normalize("大阪城と京都の金閣寺"))
    # the rebuilt occurrence index answers over the mutated corpus
    ids = {ctx.doc_store.doc_id(pk) for pk in ("2", "4")}
    assert positional_ids(ctx, "東京") == (2, sorted(ids))


def test_optimize_positional_parity_with_text_path(torch_cpu):
    ctx, cfg = make_ctx()
    ctx.add_row("200", "全文検索エンジンの観光地ガイド", {"status": 0})
    ctx.update_row("3", "日本語の形態素解析です")
    ctx.optimize()
    pipe = SearchPipeline(ctx, cfg)
    texts = {}
    for pk in [str(i) for i in range(1, len(TEXTS) + 1)] + ["200"]:
        did = ctx.doc_store.doc_id(pk)
        if did is not None:
            texts[pk] = ctx.doc_store.text(did)
    for term in ["日本", "検索", "観光地", "quick", "東京", "エンジン"]:
        out = pipe.execute(P.parse(f"SEARCH articles {term} LIMIT 20"))
        assert out.success, out.error
        got = {out.sn.doc_store.primary_key(int(d)) for d in out.results}
        needle = ctx.normalize(term)
        want = {pk for pk, t in texts.items() if needle in t}
        assert got == want, (term, got, want)
        # and the positional engine over the compacted segment
        total, ids = positional_ids(ctx, term)
        assert ids == sorted(ctx.doc_store.doc_id(pk) for pk in want)


def test_optimize_without_texts_drops_positional_gracefully(torch_cpu):
    cfg_d = dict(CFG)
    cfg_d["memory"] = {"verify_text": "off"}
    cfg = load_config_from_dict(cfg_d)
    ctx = TableCatalog(cfg).resolve("articles")
    for i, t in enumerate(TEXTS, start=1):
        ctx.add_row(str(i), t, {"status": i % 3})
    ctx.optimize()
    assert len(ctx.index.delta) == 0
    out = SearchPipeline(ctx, cfg).execute(
        P.parse("SEARCH articles quick LIMIT 10"))
    assert out.success and out.total == 4


def test_jax_dump_restores_with_positional(torch_cpu, tmp_path):
    """A dump written by the JAX package, restored by the port: the
    positional index comes back and answers as the JAX package's does."""
    jctx, _ = make_ctx(JCatalog)
    path = str(tmp_path / "jax.dump")
    jdump.save_dump(path, {"cfg": 1}, [jctx.table_state()])
    _info, tables = dump_format.load_dump(path)
    assert tables[0].positional_state is not None
    cfg = load_config_from_dict(CFG)
    ctx = restore(cfg, tables[0])
    assert ctx.index.device.positional is not None
    jdev = jctx.index.device
    for term in ["日本", "quick", "検索", "東京"]:
        pairs, _ = textproc.query_gram_offsets(ctx.normalize(term), 2, 1,
                                               True)
        to = [(jctx.index.built.term_dict.get(g), o) for g, o in pairs]
        jt, jids, _s, jpre = jdev.search_verified_positional(
            jdev.plan_positional(to), 128, True)
        assert positional_ids(ctx, term) == (
            int(jt), sorted(int(x) for x in np.asarray(jids) if x >= 0))
