"""The S3 API: its SigV4 signing (auth.py), which the S3 remote tier
(storage/backend_s3.py) signs its requests with, and the filer client
(filer_client.py) that `filer.cat` and `filer.copy` use.  The gateway
itself comes with ROADMAP A-7a."""
