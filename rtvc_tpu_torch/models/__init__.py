"""Models of the caption step: TinyViT, the student, the weight bridge."""
