"""The paper's three partly-persistent structures."""
