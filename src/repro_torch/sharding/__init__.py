from repro_torch.sharding.specs import (NamedSharding, ShardingRules,
                                        constrain, current_rules,
                                        logical_to_spec, placements,
                                        set_rules)

__all__ = ["NamedSharding", "ShardingRules", "constrain", "current_rules",
           "logical_to_spec", "placements", "set_rules"]
