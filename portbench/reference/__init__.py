"""The plain float32 reference of the edit's diffusion side, frozen from
the port's plain path and importing nothing of it: attention is a plain
softmax and every product a plain `torch` operation (`layers.precision`
switches the products to float8 for the control)."""
