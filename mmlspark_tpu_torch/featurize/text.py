"""TextFeaturizer: tokenize -> n-grams -> hashed TF -> IDF in one estimator
(reference: featurize/text/TextFeaturizer.scala builds the same SparkML
pipeline). Hashing uses murmur3 (ops/hashing).

Output layout: at the reference's 2^18 default a dense (n, 2^18) TF matrix
is 1 MB/row — the sparse pair convention (ops/sparse.py) stores the same
information as `<out>_idx`/`<out>_val` (n, max_tokens) instead. Dense output
remains available (dense_output=True, or 'auto' under 2^14 slots) for
consumers that want a matrix.

Port of `mmlspark_tpu/featurize/text.py`: tokenizing, hashing and the
IDF are host code with the reference's outputs bit for bit. The
reference takes `np.unique` of each document's hashed tokens; here every
document's tokens are hashed as one flat array (each distinct token
once) and the (document, slot) pairs are counted with one sort, which
gives the same slots, counts and order. The dense output densifies on
the stage's `device` (None = the card) through `ops.sparse.to_dense`.
"""
from __future__ import annotations

import itertools
import operator
import re

import numpy as np

from ..core import Estimator, Model, Param, Table, HasInputCol, HasOutputCol
from ..core.params import one_of
from ..ops.hashing import hash_token
from ..ops.sparse import DENSE_AUTO_LIMIT, to_dense

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class _TokenHashCache:
    """Vectorized token hashing: murmur each UNIQUE token once per batch
    (replaces the per-row per-token hot loop)."""

    def __init__(self, mask: int):
        self.mask = mask
        self.cache: dict = {}

    def __call__(self, tokens):
        out = np.empty(len(tokens), np.int64)
        for i, tok in enumerate(tokens):
            h = self.cache.get(tok)
            if h is None:
                h = hash_token(tok) & self.mask
                self.cache[tok] = h
            out[i] = h
        return out


def _tokenize(text: str, to_lower=True):
    s = str(text)
    if to_lower:
        s = s.lower()
    return _TOKEN_RE.findall(s)


def _ngrams(tokens, n):
    if n <= 1:
        return list(tokens)
    out = list(tokens)
    for k in range(2, n + 1):
        out.extend("_".join(tokens[i:i + k]) for i in range(len(tokens) - k + 1))
    return out


def _slot_counts(texts, params, mask: int):
    """(document, slot, count) of every distinct (document, hashed slot)
    pair, ordered by document then slot, and the number of documents:
    the reference's per-document `np.unique(hashes, return_counts=True)`
    for all documents at once. `params` is the stage (its tokenizer
    Params)."""
    docs = []
    for s in texts:
        toks = (_tokenize(s, params.to_lower_case) if params.use_tokenizer
                else str(s).split())
        if params.use_ngram:
            toks = _ngrams(toks, params.n_gram_length)
        docs.append(toks)
    n = len(docs)
    lens = np.fromiter(map(len, docs), np.int64, n)
    flat = list(itertools.chain.from_iterable(docs))
    codes = {tok: hash_token(tok) & mask for tok in dict.fromkeys(flat)}
    if len(flat) > 1:
        hashed = operator.itemgetter(*flat)(codes)
    else:
        hashed = [codes[tok] for tok in flat]
    slots = np.fromiter(hashed, np.int64, len(flat))
    width = mask + 1
    key = np.repeat(np.arange(n, dtype=np.int64), lens) * width + slots
    pairs, counts = np.unique(key, return_counts=True)
    return pairs // width, pairs % width, counts, n


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    use_tokenizer = Param("use_tokenizer", "regex-tokenize input", True)
    to_lower_case = Param("to_lower_case", "lowercase before tokenizing", True)
    use_ngram = Param("use_ngram", "add n-grams up to n_gram_length", False)
    n_gram_length = Param("n_gram_length", "max n-gram size", 2)
    num_features = Param("num_features", "hash slots (power of two)", 1 << 18)
    use_idf = Param("use_idf", "apply inverse document frequency", True)
    min_doc_freq = Param("min_doc_freq", "min docs for a slot to keep idf", 1)
    dense_output = Param("dense_output", "auto | True | False", "auto",
                         validator=one_of("auto", True, False))
    device = Param("device", "torch device of the dense output's "
                   "densification (None = the card)", None)

    def _fit(self, t: Table) -> "TextFeaturizerModel":
        nf = self.num_features
        idf = np.ones(nf, np.float32)
        if self.use_idf:
            _, slots, _, n_docs = _slot_counts(t[self.input_col], self,
                                               nf - 1)
            df = np.bincount(slots, minlength=nf).astype(np.int64)
            with np.errstate(divide="ignore"):
                idf = np.log((n_docs + 1.0) / (df + 1.0)).astype(np.float32)
            idf[df < self.min_doc_freq] = 0.0
        m = TextFeaturizerModel(**{k: v for k, v in self._paramMap.items()})
        m._idf = idf
        return m


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    use_tokenizer = Param("use_tokenizer", "regex-tokenize input", True)
    to_lower_case = Param("to_lower_case", "lowercase before tokenizing", True)
    use_ngram = Param("use_ngram", "add n-grams up to n_gram_length", False)
    n_gram_length = Param("n_gram_length", "max n-gram size", 2)
    num_features = Param("num_features", "hash slots (power of two)", 1 << 18)
    use_idf = Param("use_idf", "apply inverse document frequency", True)
    min_doc_freq = Param("min_doc_freq", "min docs for a slot to keep idf", 1)
    dense_output = Param("dense_output", "auto | True | False", "auto",
                         validator=one_of("auto", True, False))
    device = Param("device", "torch device of the dense output's "
                   "densification (None = the card)", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._idf = None

    def _get_state(self):
        return {"idf": self._idf}

    def _set_state(self, s):
        self._idf = np.asarray(s["idf"])

    @property
    def _dense(self) -> bool:
        d = self.dense_output
        return d is True or (d == "auto" and self.num_features <= DENSE_AUTO_LIMIT)

    def _transform(self, t: Table) -> Table:
        nf = self.num_features
        doc, slots, counts, n = _slot_counts(t[self.input_col], self, nf - 1)
        tf = counts.astype(np.float32)
        if self.use_idf and self._idf is not None:
            tf = tf * self._idf[slots]
        # the reference's rows_to_pair: each document's pairs left-aligned
        # in a (n, W) pair, W the most any document has (at least 1)
        per_doc = np.bincount(doc, minlength=n)
        width = max(int(per_doc.max()) if n else 0, 1)
        pos = np.arange(len(doc)) - np.repeat(np.cumsum(per_doc) - per_doc,
                                              per_doc)
        idx = np.zeros((n, width), np.int32)
        val = np.zeros((n, width), np.float32)
        idx[doc, pos] = slots
        val[doc, pos] = tf
        if self._dense:
            return t.with_column(self.output_col,
                                 to_dense(idx, val, nf, device=self.device))
        return (t.with_columns({f"{self.output_col}_idx": idx,
                                f"{self.output_col}_val": val})
                 .with_column_meta(f"{self.output_col}_idx",
                                   logical_width=nf))
