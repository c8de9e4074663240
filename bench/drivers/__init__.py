"""One driver a traffic mix kind: setup, measure, check, gap."""
