"""Seeded synthetic datasets (the port's own copy of
`repro.data.synthetic`; numpy seeding gives the same arrays, documents
and questions for the same arguments):

  * SIFT-like  : 128-d non-negative int-valued patch descriptors,
  * NYTimes-like: 256-d clustered, L2-normalised text embeddings,
  * a QA corpus with planted answer sentences, in the SQuAD style,
  * an LM training token stream of such documents (`lm_token_stream`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

_TOPICS = ["tiramisu", "volcano", "telescope", "marathon", "sourdough",
           "glacier", "jazz", "satellite", "orchid", "chess", "espresso",
           "monsoon", "fresco", "compiler", "harbor", "meteor", "violin",
           "reef", "tundra", "pagoda"]
_FACTS = ["originated in {p}", "was first described in {y}",
          "requires {n} distinct steps", "is celebrated every {m}",
          "costs about {n} dollars", "measures {n} meters",
          "was invented by the {p} school", "peaks during {m}"]
_PLACES = ["Italy", "Kyoto", "Peru", "Norway", "Cairo", "Texas", "Mumbai",
           "Prague", "Nairobi", "Quebec"]
_MONTHS = ["January", "April", "July", "October"]
_FILLER = ["Many visitors find this interesting.",
           "Local records mention it repeatedly.",
           "The details vary between sources.",
           "Several studies have examined the phenomenon.",
           "Its popularity has grown in recent years.",
           "Experts continue to debate the finer points.",
           "The history involves several regions.",
           "Archives preserve a number of accounts."]


def sift_like(n: int = 10000, nq: int = 100, d: int = 128, seed: int = 0):
    """Non-negative, heavy-tailed int-valued descriptors (SIFT histograms)."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 12.0, size=(n, d)).astype(np.float32)
    base = np.floor(np.clip(base, 0, 218))
    qidx = rng.choice(n, nq, replace=False)
    queries = base[qidx] + rng.normal(0, 2.0, (nq, d)).astype(np.float32)
    return base, np.clip(queries, 0, 218).astype(np.float32)


def nytimes_like(n: int = 5000, nq: int = 100, d: int = 256, seed: int = 0,
                 n_topics: int = 50):
    """Clustered, unit-norm embeddings (topic structure like text vectors)."""
    rng = np.random.default_rng(seed)
    topics = rng.normal(size=(n_topics, d)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    assign = rng.integers(0, n_topics, n)
    base = topics[assign] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    qidx = rng.choice(n, nq, replace=False)
    queries = base[qidx] + 0.05 * rng.normal(size=(nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return base.astype(np.float32), queries.astype(np.float32)


@dataclass
class QAExample:
    question: str
    answer: str
    doc_ids: Tuple[int, ...]     # documents containing the evidence


@dataclass
class QACorpus:
    docs: List[str]
    examples: List[QAExample]


def _sent(rng) -> str:
    return str(rng.choice(_FILLER))


def make_qa_corpus(n_docs: int = 200, n_questions: int = 50,
                   sentences_per_doc: int = 12,
                   seed: int = 0) -> QACorpus:
    """SQuAD-style single-document factoids: a unique (topic, fact) answer
    sentence planted inside each question's document of filler sentences
    (the reference's `make_qa_corpus("squad", ...)`)."""
    rng = np.random.default_rng(seed)
    docs: List[List[str]] = [[_sent(rng) for _ in range(sentences_per_doc)]
                             for _ in range(n_docs)]
    examples: List[QAExample] = []
    for qi in range(n_questions):
        topic = f"{_TOPICS[qi % len(_TOPICS)]}{qi}"
        fact = str(rng.choice(_FACTS))
        answer = fact.format(p=str(rng.choice(_PLACES)),
                             y=str(rng.integers(1500, 2020)),
                             n=str(rng.integers(2, 90)),
                             m=str(rng.choice(_MONTHS)))
        d1 = int(rng.integers(0, n_docs))
        docs[d1][rng.integers(1, sentences_per_doc - 1)] = \
            f"The {topic} {answer}."
        examples.append(QAExample(f"What is known about the {topic}?",
                                  answer, (d1,)))
    return QACorpus([" ".join(s) for s in docs], examples)


def lm_token_stream(tokenizer, n_tokens: int, seed: int = 0) -> np.ndarray:
    """n_tokens int32 ids for LM training: the documents of a SQuAD-style
    corpus of max(20, n_tokens // 400) documents and 50 questions from
    `seed`, each between bos and eos, in order until n_tokens are there;
    repeated from the start when the corpus is shorter."""
    corpus = make_qa_corpus(n_docs=max(20, n_tokens // 400),
                            n_questions=50, seed=seed)
    ids: List[int] = []
    for doc in corpus.docs:
        ids.extend(tokenizer.encode(doc, bos=True, eos=True))
        if len(ids) >= n_tokens:
            break
    while len(ids) < n_tokens:
        ids.extend(ids[: n_tokens - len(ids)])
    return np.asarray(ids[:n_tokens], np.int32)
