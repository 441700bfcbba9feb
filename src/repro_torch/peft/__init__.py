"""The port's parameter-efficient fine-tuning (``repro/peft``): LoRA,
QLoRA, DoRA and rsLoRA adapters."""
