"""Model code of the port.  So far the parameter shapes and their
initialisation (``backbone``) and the analytical parameter and FLOP
accounting built on them (``accounting``); the forward pass waits for the
model slice."""
