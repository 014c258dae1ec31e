from repro_torch.sharding.rules import (ShardingRules, flatten_dims,
                                        make_tp_rules, spec_for_dims)

__all__ = ["ShardingRules", "flatten_dims", "make_tp_rules", "spec_for_dims"]
