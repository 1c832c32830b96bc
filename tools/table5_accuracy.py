#!/usr/bin/env python3
"""Table-5 accuracy of the port beside the JAX package's, on the CPU:
`PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/table5_accuracy.py
[--docs 4096] [--seed 1] [--pipelines naive,edge]`.

Builds each named pipeline of both packages over the same synthetic
SQuAD-style corpus (chip_smoke's pipelines corpus by default: 4,096
documents, 16 questions, seed 1; HashEmbedder at 384; the port on its
plain versions) and prints one JSON line a pipeline with each package's
`accuracy` at the default n_probe (4) and with every cluster probed.
Like the tests, it imports both packages; the port itself never imports
the JAX package. Several minutes at the default size (the host graphs of
the EcoVector-backed pipelines)."""
import argparse
import json
import time

from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
from repro.serving import rag as jrag
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import make_qa_corpus
from repro_torch.serving import rag
from repro_torch.serving.embedder import HashEmbedder


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pipelines", default="naive,edge")
    args = ap.parse_args()
    corpus = make_qa_corpus(n_docs=args.docs, n_questions=16,
                            sentences_per_doc=12, seed=args.seed)
    jcorpus = j_make_qa_corpus("squad", n_docs=args.docs, n_questions=16,
                               sentences_per_doc=12, seed=args.seed)
    assert corpus.docs == jcorpus.docs
    for name in args.pipelines.split(","):
        t0 = time.perf_counter()
        pipe = rag.PIPELINES[name](corpus.docs, HashEmbedder(dim=384),
                                   top_k=3, device="cpu",
                                   gen_config=get_reduced("qwen25_0_5b"))
        jpipe = jrag.PIPELINES[name](jcorpus.docs, JHashEmbedder(dim=384),
                                     top_k=3)
        row = {"pipeline": name, "docs": args.docs, "seed": args.seed}
        for label, n_probe in (("n_probe 4", 4),
                               ("every cluster", pipe.index.n_clusters)):
            pipe.n_probe = jpipe.n_probe = n_probe
            row[label] = {"port": rag.accuracy(pipe, corpus.examples),
                          "reference": jrag.accuracy(jpipe,
                                                     jcorpus.examples)}
        row["s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
