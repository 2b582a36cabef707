"""RWKV-6 WKV recurrence (data-dependent decay): the wkv6 kernel."""
