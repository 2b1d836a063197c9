"""Fitted feature-engineering stages. The text stages and the embeddings
are exported here, and so is ``transmogrify``, as the JAX package's ``ops``
exports them."""
from .text_stages import (  # noqa: F401
    HumanNameDetector,
    JaccardSimilarity,
    LangDetector,
    MimeTypeDetector,
    MimeTypeMapDetector,
    NameEntityRecognizer,
    NGramSimilarity,
    OpCountVectorizer,
    OpHashingTF,
    OpIDF,
    OpIndexToString,
    OpNGram,
    OpStopWordsRemover,
    OpStringIndexer,
    TextTokenizer,
    ValidEmailTransformer,
)
from .embeddings import OpLDA, OpWord2Vec  # noqa: F401
from .transmogrify import transmogrify  # noqa: F401
