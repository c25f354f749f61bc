"""Scale-out: the height-sharded spatial mode (spatial_flagship.py) on a
group of row shards (group.py)."""
