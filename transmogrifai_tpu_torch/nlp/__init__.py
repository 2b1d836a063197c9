"""NLP models: trained name detection (OpenNLP replacement), language
identification, sentence splitting and part-of-speech tagging, as the JAX
package's ``nlp/`` has them."""
from .name_model import NameModel, name_probability, is_probable_name  # noqa: F401
