"""The plain reference of a cell's training step, and the comparison.

Plain PyTorch in float32 (TF32 off), written from the configuration's
file and the published description of the layers: the loss and
gradients of the configuration's model file (``models/<model>.py``), the
sync's int4 round trip and error feedback (``quant``), AdamW and three
steps (``train``), and the numbers that decide ``correct``
(``compare``).  It imports nothing of the port and takes nothing the port
made: it makes the weights again from the seed and draws the same
batches from the traffic generator.
"""
