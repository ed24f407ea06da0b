"""The port stands alone: it imports neither JAX nor the JAX package.

A subprocess blocks both (``sys.modules[name] = None`` makes any import of
them fail), imports every module of ``mygramdb_tpu_torch``, then loads a
small table with ``memory.verify_text: all`` and serves SEARCH, COUNT,
``SORT _score``, boolean-expression and ``FUZZY`` queries on the CPU, then
the same table at ``device.mesh_shards: 2`` (``parallel.mesh``), which
must answer the same, and with ``device.positional_verify`` (the
positional engine's counts equal the verified COUNT's). A source scan shows that no file of the port has an
import naming the JAX package.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mygramdb_tpu_torch"

SCRIPT = r"""
import json, os, pkgutil, importlib, sys
sys.modules["jax"] = None
sys.modules["mygramdb_tpu"] = None
os.environ["MYGRAM_TORCH_DEVICE"] = "cpu"
import mygramdb_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    mygramdb_tpu_torch.__path__, "mygramdb_tpu_torch."))
for name in names:
    importlib.import_module(name)
from mygramdb_tpu_torch.catalog import TableCatalog
from mygramdb_tpu_torch.config import load_config_from_dict
from mygramdb_tpu_torch.server.core import ServerCore
from mygramdb_tpu_torch.utils.corpusgen import CorpusGenerator
CFG = {
    "tables": [{"name": "articles", "text_source": {"column": "content"},
                "filters": [{"name": "status", "type": "int",
                             "bitmap_index": True}]}],
    "cache": {"enabled": False}, "memory": {"verify_text": "all"},
    "api": {"tcp": {"bind": "127.0.0.1", "port": 0}},
    "network": {"allow_cidrs": ["127.0.0.0/8"]}}
gen = CorpusGenerator(1200, seed=4, vocab_size=4000)
texts = [t for b in gen.batches(400) for _, t in b]


def serve(cfg_dict):
    cfg = load_config_from_dict(cfg_dict)
    cat = TableCatalog(cfg)
    ctx = cat.resolve("articles")
    bulk = ctx.begin_bulk_load()
    for batch in gen.batches(400):
        bulk.add_batch([(str(i), t, {"status": i % 3}) for i, t in batch])
    bulk.finish()
    return ctx, ServerCore(cfg, cat)


ctx, core = serve(CFG)
mctx, mcore = serve(dict(CFG, device={"mesh_shards": 2}))
pctx, pcore = serve(dict(CFG, device={"positional_verify": True}))
ja = [t[5:8] for t in texts if not t.isascii()][:20]
lines = [f"SEARCH articles {w} LIMIT 10" for w in gen.vocab[:20]]
lines += [f"SEARCH articles {t} SORT _score DESC LIMIT 5" for t in ja]
lines += [f"COUNT articles {w} FILTER status = 1" for w in gen.vocab[:10]]
lines += [f"SEARCH articles (({a} OR {b}) AND NOT {c}) LIMIT 10"
          for a, b, c in zip(gen.vocab[:8], gen.vocab[8:16], gen.vocab[16:24])]
lines += [f"SEARCH articles {w} FUZZY 1 LIMIT 10" for w in gen.vocab[30:36]]
out = [core.handle_line(x) for x in lines]
mesh_out = [mcore.handle_line(x) for x in lines]
# the positional engine against the verified COUNT of the same terms
from mygramdb_tpu_torch.utils import textproc
pdev, pbuilt = pctx.index.device, pctx.index.built
positional = []
for w in gen.vocab[:12] + [t.split()[0] for t in ja if t.split()][:8]:
    pairs, covered = textproc.query_gram_offsets(pctx.normalize(w), 2, 1,
                                                 True)
    tids = [pbuilt.term_dict.get(g) for g, _ in pairs]
    if not covered or not pairs or None in tids:
        continue
    plan = pdev.plan_positional([(t, o) for t, (_, o) in zip(tids, pairs)])
    if plan is not None:
        total = pdev.search_verified_positional(plan, 10, True)[0]
        positional.append([f"OK COUNT {total}",
                           pcore.handle_line(f"COUNT articles {w}")])
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and (m == "jax" or m.startswith("jax.")
                     or m == "mygramdb_tpu" or m.startswith("mygramdb_tpu.")))
print(json.dumps({"modules": len(names), "loaded": loaded,
                  "covered": [n for n in names if n.endswith((
                      ".ops.threshold_ops", ".parallel.mesh",
                      ".tools.profile_gather", ".ops.positional_ops",
                      ".client.client", ".client.expression",
                      ".cli.repl"))],
                  "positional": positional,
                  "responses": out, "mesh_responses": mesh_out,
                  "mesh_shards": mctx.index.device.mesh.shape["docs"],
                  "text_store": type(ctx.device_text).__module__}))
"""


def test_port_imports_and_serves_without_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["modules"] > 70
    assert out["covered"] == ["mygramdb_tpu_torch.cli.repl",
                              "mygramdb_tpu_torch.client.client",
                              "mygramdb_tpu_torch.client.expression",
                              "mygramdb_tpu_torch.ops.positional_ops",
                              "mygramdb_tpu_torch.ops.threshold_ops",
                              "mygramdb_tpu_torch.parallel.mesh",
                              "mygramdb_tpu_torch.tools.profile_gather"]
    # the positional engine answers as the verified COUNT does
    assert len(out["positional"]) >= 10
    assert all(a == b for a, b in out["positional"]), out["positional"]
    assert sum(a != "OK COUNT 0" for a, _ in out["positional"]) >= 5
    assert out["mesh_shards"] == 2
    assert out["mesh_responses"] == out["responses"]
    assert out["text_store"] == "mygramdb_tpu_torch.storage.device_text"
    assert all(r.startswith("OK") for r in out["responses"]), out
    assert sum(r not in ("OK RESULTS 0", "OK COUNT 0")
               for r in out["responses"]) > 25


def imported_names(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_port_file_imports_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 70
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in imported_names(f)
           if name.split(".")[0] in ("jax", "jaxlib", "mygramdb_tpu")]
    assert bad == []
