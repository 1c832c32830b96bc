"""Seeded synthetic QA corpus with planted answer sentences (the port's
own copy of `repro.data.synthetic.make_qa_corpus` in its SQuAD style;
numpy seeding gives the same documents and questions for the same
arguments)."""
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
