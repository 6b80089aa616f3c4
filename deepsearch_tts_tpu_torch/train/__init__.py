"""Training and LoRA (port of ``train/``): the SFT data pipeline
(``data``), safetensors checkpoints (``checkpoint``), LoRA adapters
(``lora``) and the SFT trainer (``trainer``)."""
