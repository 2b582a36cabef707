"""Selective scan (the Mamba/Hymba SSM recurrence): the scan kernel."""
