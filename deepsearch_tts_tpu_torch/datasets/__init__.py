from .loaders import load_dataset, extract_question, xor_decrypt, DATASET_REGISTRY

__all__ = ["load_dataset", "extract_question", "xor_decrypt", "DATASET_REGISTRY"]
