"""ECR channel compaction and block-occupancy schedules (counterpart of `repro.core`)."""
