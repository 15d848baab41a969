"""Copy of minio_tpu/storage/errors.py: the port keeps its own, so that it imports
nothing of the JAX package.

Storage error taxonomy — mirrors the reference's typed errors
(reference cmd/storage-errors.go) so quorum reduction can classify
failures the same way."""


class StorageError(Exception):
    pass


class ErrDiskNotFound(StorageError):
    pass


class ErrFaultyDisk(StorageError):
    pass


class ErrDiskFull(StorageError):
    pass


class ErrVolumeNotFound(StorageError):
    pass


class ErrVolumeExists(StorageError):
    pass


class ErrVolumeNotEmpty(StorageError):
    pass


class ErrFileNotFound(StorageError):
    pass


class ErrFileVersionNotFound(StorageError):
    pass


class ErrFileCorrupt(StorageError):
    pass


class ErrFileAccessDenied(StorageError):
    pass


class ErrIsNotRegular(StorageError):
    pass


class ErrPathNotFound(StorageError):
    pass


class ErrMethodNotAllowed(StorageError):
    pass


class ErrDoneForNow(StorageError):
    """Listing pagination sentinel."""


class ErrErasureReadQuorum(StorageError):
    """Not enough drives agree to serve a read."""


class ErrErasureWriteQuorum(StorageError):
    """Not enough drives acknowledged a write."""


class ErrObjectNotFound(StorageError):
    pass


class ErrVersionNotFound(StorageError):
    pass


class ErrBucketNotFound(StorageError):
    pass


class ErrBucketExists(StorageError):
    pass


class ErrBucketNotEmpty(StorageError):
    pass


class ErrInvalidArgument(StorageError):
    pass


class ErrUploadNotFound(StorageError):
    """Multipart upload id does not exist."""


class ErrInvalidPart(StorageError):
    """CompleteMultipartUpload referenced a missing/mismatched part."""
