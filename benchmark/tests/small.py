"""A small size of each cell that a CPU test run can hold: the same
traffic, fewer and smaller frames."""

SMALL = {"frame_hw": [96, 128], "object_hw": [48, 64]}
OVERRIDES = {
    "video_b8_1080p": {**SMALL, "batch": 4, "pool": 2, "warmup_requests": 2,
                       "profile_requests": 1, "check_batches": 2},
    "object_1080p": {**SMALL, "pool": 2, "warmup_requests": 2,
                     "profile_requests": 1, "check_pairs": 2},
}
# window seconds of a small run (the window also serves the whole pool)
SECONDS = 1.0
