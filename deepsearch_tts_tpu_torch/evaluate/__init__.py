from .extract import extract_answer_fn, extract_boxed
from .math_equivalence import is_equiv
from .metrics import evaluate_predictions, run_evaluation, normalize_answer_qa

__all__ = [
    "extract_answer_fn",
    "extract_boxed",
    "is_equiv",
    "evaluate_predictions",
    "run_evaluation",
    "normalize_answer_qa",
]
