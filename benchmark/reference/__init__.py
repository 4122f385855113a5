"""The plain reference of the fused tracking step: frozen plain-PyTorch
copies of the port's modules, importing nothing of the port."""
