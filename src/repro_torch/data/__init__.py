from .pipeline import (ShardedTokenSource, SyntheticTokenSource,
                       UMTPrefetcher, batch_for_step, write_token_shards)

__all__ = ["ShardedTokenSource", "SyntheticTokenSource", "UMTPrefetcher",
           "batch_for_step", "write_token_shards"]
