from repro_torch.sharding.specs import (ShardingRules, constrain,
                                        current_rules, logical_to_spec,
                                        placements, set_rules)

__all__ = ["ShardingRules", "constrain", "current_rules", "logical_to_spec",
           "placements", "set_rules"]
