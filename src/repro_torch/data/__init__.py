from repro_torch.data.index import SampleIndex  # noqa: F401
