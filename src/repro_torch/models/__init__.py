"""Model code of the port: parameter and cache shapes and their
initialisation, dense layer application (``backbone``), the layers
(``layers``), the prefill/decode programs (``model``), and the analytical
parameter and FLOP accounting (``accounting``)."""
