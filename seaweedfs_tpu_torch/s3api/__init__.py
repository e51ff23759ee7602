"""The S3 API: only its SigV4 signing so far (auth.py), which the S3 remote
tier (storage/backend_s3.py) signs its requests with.  The gateway itself
comes with ROADMAP A-7."""
