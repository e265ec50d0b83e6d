from repro_torch.data.pipeline import (DataConfig, MemmapTokenSource,
                                       SyntheticTokenSource, TokenPipeline)

__all__ = ["DataConfig", "TokenPipeline", "SyntheticTokenSource",
           "MemmapTokenSource"]
