"""The plain reference of what the program computes: Dia-1.6B's forward
(``dia.py``), the codec's decoder (``dac.py``) and the request's text and
token layout (``text.py``), in float32 PyTorch, importing nothing of the
program."""
