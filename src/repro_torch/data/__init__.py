from repro_torch.data.pipeline import (  # noqa: F401
    DataCursor, SyntheticLMStream, SyntheticMelStream, make_stream,
)
