"""S3 API error registry: code -> (HTTP status, default message) + the
storage-error -> API-error mapping (a copy of
minio_tpu/server/api_errors.py over the port's errors).

The reference keeps ~300 codes in cmd/api-errors.go with a toAPIErrorCode
translation; this is the subset our surface emits, structured the same
way (XML error body with Code/Message/Resource/RequestId).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class APIError:
    code: str
    http_status: int
    message: str


_E = APIError

ERRORS: dict[str, APIError] = {e.code: e for e in [
    _E("AccessDenied", 403, "Access Denied."),
    _E("BadDigest", 400, "The Content-Md5 you specified did not match what we received."),
    _E("BucketAlreadyOwnedByYou", 409, "Your previous request to create the named bucket succeeded and you already own it."),
    _E("BucketAlreadyExists", 409, "The requested bucket name is not available."),
    _E("BucketNotEmpty", 409, "The bucket you tried to delete is not empty."),
    _E("EntityTooLarge", 400, "Your proposed upload exceeds the maximum allowed object size."),
    _E("EntityTooSmall", 400, "Your proposed upload is smaller than the minimum allowed object size."),
    _E("IncompleteBody", 400, "You did not provide the number of bytes specified by the Content-Length HTTP header."),
    _E("InternalError", 500, "We encountered an internal error, please try again."),
    _E("InvalidAccessKeyId", 403, "The Access Key Id you provided does not exist in our records."),
    _E("InvalidArgument", 400, "Invalid Argument."),
    _E("InvalidBucketName", 400, "The specified bucket is not valid."),
    _E("InvalidDigest", 400, "The Content-Md5 you specified is not valid."),
    _E("InvalidPart", 400, "One or more of the specified parts could not be found."),
    _E("InvalidPartOrder", 400, "The list of parts was not in ascending order."),
    _E("InvalidRange", 416, "The requested range is not satisfiable."),
    _E("InvalidRequest", 400, "Invalid Request."),
    _E("KeyTooLongError", 400, "Your key is too long."),
    _E("MalformedXML", 400, "The XML you provided was not well-formed or did not validate against our published schema."),
    _E("MethodNotAllowed", 405, "The specified method is not allowed against this resource."),
    _E("MissingContentLength", 411, "You must provide the Content-Length HTTP header."),
    _E("NoSuchBucket", 404, "The specified bucket does not exist."),
    _E("NoSuchBucketPolicy", 404, "The bucket policy does not exist."),
    _E("NoSuchKey", 404, "The specified key does not exist."),
    _E("NoSuchUpload", 404, "The specified multipart upload does not exist."),
    _E("NoSuchVersion", 404, "The specified version does not exist."),
    _E("NotImplemented", 501, "A header you provided implies functionality that is not implemented."),
    _E("PreconditionFailed", 412, "At least one of the pre-conditions you specified did not hold."),
    _E("NotModified", 304, "Not Modified."),
    _E("RequestTimeTooSkewed", 403, "The difference between the request time and the server's time is too large."),
    _E("SignatureDoesNotMatch", 403, "The request signature we calculated does not match the signature you provided."),
    _E("SlowDown", 503, "Please reduce your request rate."),
    _E("XAmzContentSHA256Mismatch", 400, "The provided 'x-amz-content-sha256' header does not match what was computed."),
    _E("AuthorizationHeaderMalformed", 400, "The authorization header is malformed."),
    _E("ExpiredToken", 400, "The provided token has expired."),
    _E("AuthorizationQueryParametersError", 400, "Query-string authentication parameters are malformed."),
    _E("ServiceUnavailable", 503, "The server is currently unavailable. Please retry."),
    _E("QuotaExceeded", 403, "Bucket quota exceeded."),
    _E("NoSuchLifecycleConfiguration", 404, "The lifecycle configuration does not exist."),
    _E("NoSuchTagSet", 404, "The TagSet does not exist."),
    _E("ReplicationConfigurationNotFoundError", 404, "The replication configuration was not found."),
    _E("ServerSideEncryptionConfigurationNotFoundError", 404, "The server side encryption configuration was not found."),
    _E("NoSuchObjectLockConfiguration", 404, "The specified object does not have an ObjectLock configuration."),
    _E("ObjectLocked", 400, "Object is WORM protected and cannot be overwritten or deleted."),
    _E("InvalidRetentionDate", 400, "Date must be provided in ISO 8601 format."),
    _E("NoSuchNotificationConfiguration", 404, "The specified bucket does not have a notification configuration."),
    _E("SelectParseError", 400, "The SQL expression could not be parsed."),
    _E("InvalidObjectState", 403, "The operation is not valid for the object's storage class."),
    # -- breadth batch (cf. cmd/api-errors.go; AWS-public code table) --------
    _E("AccessForbidden", 403, "Access forbidden."),
    _E("AllAccessDisabled", 403, "All access to this resource has been disabled."),
    _E("AmbiguousGrantByEmailAddress", 400, "The email address you provided is associated with more than one account."),
    _E("BadRequest", 400, "400 BadRequest."),
    _E("BucketTaggingNotFound", 404, "The TagSet does not exist."),
    _E("CredentialTypeMismatch", 400, "The provided credential type does not match the request."),
    _E("CrossLocationLoggingProhibited", 403, "Cross-location logging not allowed."),
    _E("ExpiredPresignRequest", 403, "Request has expired."),
    _E("IllegalLocationConstraintException", 400, "The specified location-constraint is not valid."),
    _E("IllegalVersioningConfigurationException", 400, "The versioning configuration specified in the request is invalid."),
    _E("IncorrectNumberOfFilesInPostRequest", 400, "POST requires exactly one file upload per request."),
    _E("InlineDataTooLarge", 400, "Inline data exceeds the maximum allowed size."),
    _E("InsecureClientRequest", 400, "Cannot respond to plain-text request from TLS-encrypted server."),
    _E("InvalidAddressingHeader", 400, "You must specify the Anonymous role."),
    _E("InvalidBucketState", 409, "The request is not valid with the current state of the bucket."),
    _E("InvalidCopyDest", 400, "This copy request is illegal because it is trying to copy an object to itself without changing the object's metadata, storage class, website redirect location or encryption attributes."),
    _E("InvalidCopySource", 400, "Copy Source must mention the source bucket and key: sourcebucket/sourcekey."),
    _E("InvalidDuration", 400, "Duration provided in the request is invalid."),
    _E("InvalidEncryptionAlgorithmError", 400, "The encryption request you specified is not valid. The valid value is AES256."),
    _E("InvalidEncryptionMethod", 400, "The encryption method specified is not supported."),
    _E("InvalidLifecycleWithObjectLock", 400, "The lifecycle configuration is not valid with object lock enabled."),
    _E("InvalidLocationConstraint", 400, "The specified location constraint is not valid."),
    _E("InvalidMaxKeys", 400, "Argument maxKeys must be an integer between 0 and 2147483647."),
    _E("InvalidMaxParts", 400, "Part number must be an integer between 1 and 10000, inclusive."),
    _E("InvalidMaxUploads", 400, "Argument max-uploads must be an integer between 0 and 2147483647."),
    _E("InvalidPartNumberMarker", 400, "Argument partNumberMarker must be an integer."),
    _E("InvalidPayer", 403, "All access to this object has been disabled."),
    _E("InvalidPolicyDocument", 400, "The content of the form does not meet the conditions specified in the policy document."),
    _E("InvalidPrefix", 400, "Invalid prefix."),
    _E("InvalidRegion", 400, "Region does not match."),
    _E("InvalidSecurity", 403, "The provided security credentials are not valid."),
    _E("InvalidSOAPRequest", 400, "The SOAP request body is invalid."),
    _E("InvalidStorageClass", 400, "The storage class you specified is not valid."),
    _E("InvalidTag", 400, "The tag provided was not a valid tag. This error can occur if the tag did not pass input validation."),
    _E("InvalidTargetBucketForLogging", 400, "The target bucket for logging does not exist."),
    _E("InvalidToken", 400, "The provided token is malformed or otherwise invalid."),
    _E("InvalidURI", 400, "Couldn't parse the specified URI."),
    _E("InvalidVersionId", 400, "Invalid version id specified."),
    _E("KMSNotConfigured", 501, "Server side encryption specified but KMS is not configured."),
    _E("MalformedACLError", 400, "The XML you provided was not well-formed or did not validate against our published schema."),
    _E("MalformedDate", 400, "Invalid date format header, expected to be in ISO8601, RFC1123 or RFC1123Z time format."),
    _E("MalformedPolicy", 400, "Policy has invalid resource."),
    _E("MalformedPOSTRequest", 400, "The body of your POST request is not well-formed multipart/form-data."),
    _E("MaxMessageLengthExceeded", 400, "Your request was too big."),
    _E("MaxPostPreDataLengthExceededError", 400, "Your POST request fields preceding the upload file were too large."),
    _E("MetadataTooLarge", 400, "Your metadata headers exceed the maximum allowed metadata size."),
    _E("MissingAttachment", 400, "A SOAP attachment was expected, but none were found."),
    _E("MissingContentMD5", 400, "Missing required header for this request: Content-Md5."),
    _E("MissingRequestBodyError", 400, "Request body is empty."),
    _E("MissingSecurityElement", 400, "The SOAP 1.1 request is missing a security element."),
    _E("MissingSecurityHeader", 400, "Your request was missing a required header."),
    _E("NoLoggingStatusForKey", 400, "There is no such thing as a logging status subresource for a key."),
    _E("NoSuchCORSConfiguration", 404, "The CORS configuration does not exist."),
    _E("NoSuchWebsiteConfiguration", 404, "The specified bucket does not have a website configuration."),
    _E("NotSignedUp", 403, "Your account is not signed up."),
    _E("OperationAborted", 409, "A conflicting conditional operation is currently in progress against this resource. Please try again."),
    _E("OperationTimedOut", 503, "A timeout occurred while trying to lock a resource, please reduce your request rate."),
    _E("PermanentRedirect", 301, "The bucket you are attempting to access must be addressed using the specified endpoint. Please send all future requests to this endpoint."),
    _E("Redirect", 307, "Temporary redirect."),
    _E("RequestIsNotMultiPartContent", 400, "Bucket POST must be of the enclosure-type multipart/form-data."),
    _E("RequestTimeout", 400, "Your socket connection to the server was not read from or written to within the timeout period."),
    _E("RequestTorrentOfBucketError", 400, "Requesting the torrent file of a bucket is not permitted."),
    _E("RestoreAlreadyInProgress", 409, "Object restore is already in progress."),
    _E("ServerNotInitialized", 503, "Server not initialized, please try again."),
    _E("TemporaryRedirect", 307, "You are being redirected to the bucket while DNS updates."),
    _E("TokenRefreshRequired", 400, "The provided token must be refreshed."),
    _E("TooManyBuckets", 400, "You have attempted to create more buckets than allowed."),
    _E("UnexpectedContent", 400, "This request does not support content."),
    _E("UnresolvableGrantByEmailAddress", 400, "The email address you provided does not match any account on record."),
    _E("UserKeyMustBeSpecified", 400, "The bucket POST must contain the specified field name. If it is specified, please check the order of the fields."),
    _E("ObjectLockConfigurationNotAllowed", 400, "Object Lock configuration cannot be enabled on existing buckets."),
    _E("InvalidRetentionMode", 400, "Unknown WORM mode directive."),
    _E("InvalidLegalHoldStatus", 400, "The legal hold status you specified is not valid."),
    _E("ObjectLockInvalidHeaders", 400, "x-amz-object-lock-retain-until-date and x-amz-object-lock-mode must both be supplied."),
    _E("PastObjectLockRetainDate", 400, "the retain until date must be in the future."),
    _E("UnknownWORMModeDirective", 400, "Unknown WORM mode directive."),
    _E("NoSuchServiceAccount", 404, "The specified service account is not found."),
    _E("AdminInvalidAccessKey", 400, "The access key is invalid."),
    _E("AdminInvalidSecretKey", 400, "The secret key is invalid."),
    _E("AdminNoSuchUser", 404, "The specified user does not exist."),
    _E("AdminNoSuchGroup", 404, "The specified group does not exist."),
    _E("AdminNoSuchPolicy", 404, "The canned policy does not exist."),
    _E("AdminGroupNotEmpty", 400, "The specified group is not empty - cannot remove it."),
    _E("AdminConfigBadJSON", 400, "JSON configuration provided is of incorrect format."),
    _E("HealNotImplemented", 501, "This server does not implement heal functionality."),
    _E("HealNoSuchProcess", 404, "No such heal process is running on the server."),
    _E("HealInvalidClientToken", 400, "Client token mismatch."),
    _E("BackendDown", 503, "Remote backend is unreachable."),
    _E("ParentIsObject", 400, "Object-prefix is already an object, please choose a different object-prefix name."),
    _E("StorageFull", 507, "Storage backend has reached its minimum free drive threshold. Please delete a few objects to proceed."),
    _E("ObjectExistsAsDirectory", 409, "Object name already exists as a directory."),
    _E("PreconditionRequired", 428, "At least one precondition header is required for this request."),
    _E("UnsupportedNotification", 400, "MinIO server does not support Topic or Cloud Function based notifications."),
    _E("ContentSHA256Mismatch", 400, "The provided 'x-amz-content-sha256' header does not match what was computed."),
    _E("LifecycleNotAllowed", 400, "Lifecycle configuration is not allowed on this bucket."),
    _E("ReplicationNeedsVersioningError", 400, "Versioning must be 'Enabled' on the bucket to apply a replication configuration."),
    _E("ReplicationBucketNeedsVersioningError", 400, "Versioning must be 'Enabled' on the bucket to add a replication target."),
    _E("RemoteTargetNotFoundError", 404, "The remote target does not exist."),
    _E("ReplicationRemoteConnectionError", 503, "Remote service connection error - please check remote service credentials and target bucket."),
    _E("TransitionStorageClassNotFoundError", 404, "The transition storage class was not found."),
    _E("NoSuchObjectLockRetention", 404, "The specified object does not have a Retention configuration."),
    _E("NoSuchObjectLegalHold", 404, "The specified object does not have a LegalHold configuration."),
    _E("ObjectRestoreAlreadyInProgress", 409, "Object restore is already in progress."),
    _E("InvalidDecompressedSize", 400, "The data provided is unfit for decompression."),
    _E("AddUserInvalidArgument", 400, "User is not allowed to be same as admin access key."),
    _E("PolicyTooLarge", 400, "Policy exceeds the maximum allowed document size."),
    _E("BusyOperation", 409, "A conflicting operation is in progress."),
    _E("ClientDisconnected", 499, "Client disconnected before response was ready."),
    _E("InvalidSessionToken", 403, "The provided session token is invalid."),
    # -- full-parity batch r4 (cf. cmd/api-errors.go): every wire
    # code the reference's registry can emit, so error mapping
    # and client SDK expectations match 1:1 ------------------------
    _E("AuthorizationParametersError", 400, "Error parsing the Credential/X-Amz-Credential parameter; incorrect service. This endpoint belongs to 's3'."),
    _E("Busy", 503, "The service is unavailable. Please retry."),
    _E("CastFailed", 400, "Attempt to convert from one data type to another using CAST failed in the SQL expression."),
    _E("EmptyRequestBody", 400, "Request body cannot be empty."),
    _E("ErrEvaluatorBindingDoesNotExist", 400, "A column name or a path provided does not exist in the SQL expression"),
    _E("EvaluatorInvalidArguments", 400, "Incorrect number of arguments in the function call in the SQL expression."),
    _E("EvaluatorInvalidTimestampFormatPattern", 400, "Time stamp format pattern requires additional fields in the SQL expression."),
    _E("EvaluatorInvalidTimestampFormatPatternSymbol", 400, "Time stamp format pattern contains an invalid symbol in the SQL expression."),
    _E("EvaluatorInvalidTimestampFormatPatternSymbolForParsing", 400, "Time stamp format pattern contains a valid format symbol that cannot be applied to time stamp parsing in the SQL expression."),
    _E("EvaluatorInvalidTimestampFormatPatternToken", 400, "Time stamp format pattern contains an invalid token in the SQL expression."),
    _E("EvaluatorTimestampFormatPatternDuplicateFields", 400, "Time stamp format pattern contains multiple format specifiers representing the time stamp field in the SQL expression."),
    _E("EvaluatorUnterminatedTimestampFormatPatternToken", 400, "Time stamp format pattern contains unterminated token in the SQL expression."),
    _E("ExpressionTooLong", 400, "The SQL expression is too long: The maximum byte-length for the SQL expression is 256 KB."),
    _E("IllegalSqlFunctionArgument", 400, "Illegal argument was used in the SQL function."),
    _E("IncorrectSqlFunctionArgumentType", 400, "Incorrect type of arguments in function call in the SQL expression."),
    _E("IntegerOverflow", 400, "Int overflow or underflow in the SQL expression."),
    _E("InvalidCast", 400, "Attempt to convert from one data type to another using CAST failed in the SQL expression."),
    _E("InvalidColumnIndex", 400, "The column index is invalid. Please check the service documentation and try again."),
    _E("InvalidCompressionFormat", 400, "The file is not in a supported compression format. Only GZIP is supported at this time."),
    _E("InvalidDataSource", 400, "Invalid data source type. Only CSV and JSON are supported at this time."),
    _E("InvalidDataType", 400, "The SQL expression contains an invalid data type."),
    _E("InvalidExpressionType", 400, "The ExpressionType is invalid. Only SQL expressions are supported at this time."),
    _E("InvalidFileHeaderInfo", 400, "The FileHeaderInfo is invalid. Only NONE, USE, and IGNORE are supported."),
    _E("InvalidJsonType", 400, "The JsonType is invalid. Only DOCUMENT and LINES are supported at this time."),
    _E("InvalidKeyPath", 400, "Key path in the SQL expression is invalid."),
    _E("InvalidPartNumber", 416, "The requested partnumber is not satisfiable"),
    _E("InvalidPrefixMarker", 400, "Invalid marker prefix combination"),
    _E("InvalidQuoteFields", 400, "The QuoteFields is invalid. Only ALWAYS and ASNEEDED are supported."),
    _E("InvalidRequestParameter", 400, "The value of a parameter in SelectRequest element is invalid. Check the service API documentation and try again."),
    _E("InvalidTableAlias", 400, "The SQL expression contains an invalid table alias."),
    _E("InvalidTextEncoding", 400, "Invalid encoding type. Only UTF-8 encoding is supported at this time."),
    _E("InvalidTokenId", 403, "The security token included in the request is invalid"),
    _E("LexerInvalidChar", 400, "The SQL expression contains an invalid character."),
    _E("LexerInvalidIONLiteral", 400, "The SQL expression contains an invalid operator."),
    _E("LexerInvalidLiteral", 400, "The SQL expression contains an invalid operator."),
    _E("LexerInvalidOperator", 400, "The SQL expression contains an invalid literal."),
    _E("LikeInvalidInputs", 400, "Invalid argument given to the LIKE clause in the SQL expression."),
    _E("MissingFields", 400, "Missing fields in request."),
    _E("MissingHeaders", 400, "Some headers in the query are missing from the file. Check the file and try again."),
    _E("MissingRequiredParameter", 400, "The SelectRequest entity is missing a required parameter. Check the service documentation and try again."),
    _E("NoSuchBucketLifecycle", 404, "The bucket lifecycle configuration does not exist"),
    _E("ObjectLockConfigurationNotFoundError", 404, "Object Lock configuration does not exist for this bucket"),
    _E("ObjectSerializationConflict", 400, "The SelectRequest entity can only contain one of CSV or JSON. Check the service documentation and try again."),
    _E("ParseAsteriskIsNotAloneInSelectList", 400, "Other expressions are not allowed in the SELECT list when '*' is used without dot notation in the SQL expression."),
    _E("ParseCannotMixSqbAndWildcardInSelectList", 400, "Cannot mix [] and * in the same expression in a SELECT list in SQL expression."),
    _E("ParseCastArity", 400, "The SQL expression CAST has incorrect arity."),
    _E("ParseEmptySelect", 400, "The SQL expression contains an empty SELECT."),
    _E("ParseExpected2TokenTypes", 400, "Did not find the expected token in the SQL expression."),
    _E("ParseExpectedArgumentDelimiter", 400, "Did not find the expected argument delimiter in the SQL expression."),
    _E("ParseExpectedDatePart", 400, "Did not find the expected date part in the SQL expression."),
    _E("ParseExpectedExpression", 400, "Did not find the expected SQL expression."),
    _E("ParseExpectedIdentForAlias", 400, "Did not find the expected identifier for the alias in the SQL expression."),
    _E("ParseExpectedIdentForAt", 400, "Did not find the expected identifier for AT name in the SQL expression."),
    _E("ParseExpectedIdentForGroupName", 400, "GROUP is not supported in the SQL expression."),
    _E("ParseExpectedKeyword", 400, "Did not find the expected keyword in the SQL expression."),
    _E("ParseExpectedLeftParenAfterCast", 400, "Did not find expected the left parenthesis in the SQL expression."),
    _E("ParseExpectedLeftParenBuiltinFunctionCall", 400, "Did not find the expected left parenthesis in the SQL expression."),
    _E("ParseExpectedLeftParenValueConstructor", 400, "Did not find expected the left parenthesis in the SQL expression."),
    _E("ParseExpectedMember", 400, "The SQL expression contains an unsupported use of MEMBER."),
    _E("ParseExpectedNumber", 400, "Did not find the expected number in the SQL expression."),
    _E("ParseExpectedRightParenBuiltinFunctionCall", 400, "Did not find the expected right parenthesis character in the SQL expression."),
    _E("ParseExpectedTokenType", 400, "Did not find the expected token in the SQL expression."),
    _E("ParseExpectedTypeName", 400, "Did not find the expected type name in the SQL expression."),
    _E("ParseExpectedWhenClause", 400, "Did not find the expected WHEN clause in the SQL expression. CASE is not supported."),
    _E("ParseInvalidContextForWildcardInSelectList", 400, "Invalid use of * in SELECT list in the SQL expression."),
    _E("ParseInvalidTypeParam", 400, "The SQL expression contains an invalid parameter value."),
    _E("ParseMalformedJoin", 400, "JOIN is not supported in the SQL expression."),
    _E("ParseMissingIdentAfterAt", 400, "Did not find the expected identifier after the @ symbol in the SQL expression."),
    _E("ParseNonUnaryAgregateFunctionCall", 400, "Only one argument is supported for aggregate functions in the SQL expression."),
    _E("ParseSelectMissingFrom", 400, "GROUP is not supported in the SQL expression."),
    _E("ParseUnexpectedKeyword", 400, "The SQL expression contains an unexpected keyword."),
    _E("ParseUnexpectedOperator", 400, "The SQL expression contains an unexpected operator."),
    _E("ParseUnexpectedTerm", 400, "The SQL expression contains an unexpected term."),
    _E("ParseUnexpectedToken", 400, "The SQL expression contains an unexpected token."),
    _E("ParseUnknownOperator", 400, "The SQL expression contains an invalid operator."),
    _E("ParseUnsupportedAlias", 400, "The SQL expression contains an unsupported use of ALIAS."),
    _E("ParseUnsupportedCallWithStar", 400, "Only COUNT with (*) as a parameter is supported in the SQL expression."),
    _E("ParseUnsupportedCase", 400, "The SQL expression contains an unsupported use of CASE."),
    _E("ParseUnsupportedCaseClause", 400, "The SQL expression contains an unsupported use of CASE."),
    _E("ParseUnsupportedLiteralsGroupBy", 400, "The SQL expression contains an unsupported use of GROUP BY."),
    _E("ParseUnsupportedSelect", 400, "The SQL expression contains an unsupported use of SELECT."),
    _E("ParseUnsupportedSyntax", 400, "The SQL expression contains unsupported syntax."),
    _E("ParseUnsupportedToken", 400, "The SQL expression contains an unsupported token."),
    _E("PostPolicyInvalidKeyName", 403, "Invalid according to Policy: Policy Condition failed"),
    _E("RemoteDestinationNotFoundError", 404, "The remote destination bucket does not exist"),
    _E("RemoteTargetNotVersionedError", 400, "The remote target does not have versioning enabled"),
    _E("ReplicationDestinationMissingLockError", 400, "The replication destination bucket does not have object locking enabled"),
    _E("ReplicationSourceNotVersionedError", 400, "The replication source does not have versioning enabled"),
    _E("UnauthorizedAccess", 401, "You are not authorized to perform this operation"),
    _E("UnsupportedFunction", 400, "Encountered an unsupported SQL function."),
    _E("UnsupportedRangeHeader", 400, "Range header is not supported for this operation."),
    _E("UnsupportedSqlOperation", 400, "Encountered an unsupported SQL operation."),
    _E("UnsupportedSqlStructure", 400, "Encountered an unsupported SQL structure. Check the SQL Reference."),
    _E("UnsupportedSyntax", 400, "Encountered invalid syntax."),
    _E("ValueParseFailure", 400, "Time stamp parse failure in the SQL expression."),
    _E("XMinioAdminBucketQuotaExceeded", 400, "Bucket quota exceeded"),
    _E("XMinioAdminBucketRemoteAlreadyExists", 400, "The remote target already exists"),
    _E("XMinioAdminBucketRemoteLabelInUse", 400, "The remote target with this label already exists"),
    _E("XMinioAdminConfigBadJSON", 400, "JSON configuration provided is of incorrect format"),
    _E("XMinioAdminConfigDuplicateKeys", 400, "JSON configuration provided has objects with duplicate keys"),
    _E("XMinioAdminConfigNoQuorum", 503, "Configuration update failed because server quorum was not met"),
    _E("XMinioAdminCredentialsMismatch", 503, "Credentials in config mismatch with server environment variables"),
    _E("XMinioAdminGroupNotEmpty", 400, "The specified group is not empty - cannot remove it."),
    _E("XMinioAdminInvalidAccessKey", 400, "The access key is invalid."),
    _E("XMinioAdminInvalidArgument", 400, "Invalid arguments specified."),
    _E("XMinioAdminInvalidSecretKey", 400, "The secret key is invalid."),
    _E("XMinioAdminNoSuchGroup", 404, "The specified group does not exist."),
    _E("XMinioAdminNoSuchPolicy", 404, "The canned policy does not exist."),
    _E("XMinioAdminNoSuchQuotaConfiguration", 404, "The quota configuration does not exist"),
    _E("XMinioAdminNoSuchUser", 404, "The specified user does not exist."),
    _E("XMinioAdminNotificationTargetsTestFailed", 400, "Configuration update failed due an unsuccessful attempt to connect to one or more notification servers"),
    _E("XMinioAdminProfilerNotEnabled", 400, "Unable to perform the requested operation because profiling is not enabled"),
    _E("XMinioAdminRemoteARNTypeInvalid", 400, "The bucket remote ARN type is not valid"),
    _E("XMinioAdminRemoteArnInvalid", 400, "The bucket remote ARN does not have correct format"),
    _E("XMinioAdminRemoteIdenticalToSource", 400, "The remote target cannot be identical to source"),
    _E("XMinioAdminRemoteRemoveDisallowed", 400, "This ARN is in use by an existing configuration"),
    _E("XMinioAdminRemoteTargetNotFoundError", 404, "The remote target does not exist"),
    _E("XMinioAdminReplicationBandwidthLimitError", 400, "Bandwidth limit for remote target must be atleast 100MBps"),
    _E("XMinioAdminReplicationRemoteConnectionError", 404, "Remote service connection error - please check remote service credentials and target bucket"),
    _E("XMinioBackendDown", 503, "Object storage backend is unreachable"),
    _E("XMinioHealAlreadyRunning", 400, "A heal sequence is already running on this path."),
    _E("XMinioHealInvalidClientToken", 400, "Client token mismatch"),
    _E("XMinioHealMissingBucket", 400, "A heal start request with a non-empty object-prefix parameter requires a bucket to be specified."),
    _E("XMinioHealNoSuchProcess", 400, "No such heal process is running on the server"),
    _E("XMinioHealNotImplemented", 400, "This server does not implement heal functionality."),
    _E("XMinioHealOverlappingPaths", 400, "A heal sequence on an overlapping path is already running."),
    _E("XMinioInsecureClientRequest", 400, "Cannot respond to plain-text request from TLS-encrypted server"),
    _E("XMinioInvalidDecompressedSize", 400, "The data provided is unfit for decompression"),
    _E("XMinioInvalidIAMCredentials", 403, "User is not allowed to be same as admin access key"),
    _E("XMinioInvalidObjectName", 400, "Object name contains unsupported characters."),
    _E("XMinioInvalidResourceName", 400, "Resource name contains bad components such as '..' or '.'."),
    _E("XMinioMalformedJSON", 400, "The JSON you provided was not well-formed or did not validate against our published format."),
    _E("XMinioObjectExistsAsDirectory", 409, "Object name already exists as a directory."),
    _E("XMinioReplicationNoMatchingRule", 400, "No matching replication rule found for this object prefix"),
    _E("XMinioRequestBodyParse", 400, "The request body failed to parse."),
    _E("XMinioServerNotInitialized", 503, "Server not initialized, please try again."),
    _E("XMinioSiteReplicationBackendIssue", 503, "Error when requesting object layer backend"),
    _E("XMinioSiteReplicationBucketConfigError", 503, "Error while configuring replication on a bucket"),
    _E("XMinioSiteReplicationBucketMetaError", 503, "Error while replicating bucket metadata"),
    _E("XMinioSiteReplicationIAMError", 503, "Error while replicating an IAM item"),
    _E("XMinioSiteReplicationInvalidRequest", 400, "Invalid site-replication request"),
    _E("XMinioSiteReplicationPeerResp", 503, "Error received when contacting a peer site"),
    _E("XMinioSiteReplicationServiceAccountError", 503, "Site replication related service account error"),
    _E("XMinioStorageFull", 507, "Storage backend has reached its minimum free disk threshold. Please delete a few objects to proceed."),
]}


class S3Error(Exception):
    """Raise anywhere in a handler to short-circuit into an XML error."""

    def __init__(self, code: str, message: str | None = None):
        self.api = ERRORS[code]
        self.message = message or self.api.message
        super().__init__(f"{code}: {self.message}")


def from_storage_error(e: Exception) -> S3Error:
    """Map engine/storage exceptions to API errors
    (cf. toAPIErrorCode, cmd/api-errors.go).  The engine is imported
    here, not with the module: the S3 client and the signers import this
    module, and a client process loads no torch."""
    if isinstance(e, S3Error):
        return e
    from ..cluster.nslock import LockLost
    from ..engine import multipart as mp
    from ..storage import errors as se
    if isinstance(e, LockLost):
        # Lock contention/loss is retryable, not a server fault
        # (the reference maps lock timeouts to 503).
        return S3Error("SlowDown", str(e))
    if isinstance(e, se.ErrBucketNotFound):
        return S3Error("NoSuchBucket")
    if isinstance(e, se.ErrBucketExists):
        return S3Error("BucketAlreadyOwnedByYou")
    if isinstance(e, (mp.ErrUploadNotFound, se.ErrUploadNotFound)):
        return S3Error("NoSuchUpload")
    if isinstance(e, mp.ErrPartTooSmall):
        return S3Error("EntityTooSmall")
    if isinstance(e, mp.ErrInvalidPartOrder):
        return S3Error("InvalidPartOrder")
    if isinstance(e, (mp.ErrInvalidPart, se.ErrInvalidPart)):
        return S3Error("InvalidPart")
    if isinstance(e, (se.ErrVersionNotFound, se.ErrFileVersionNotFound)):
        return S3Error("NoSuchVersion")
    if isinstance(e, (se.ErrObjectNotFound, se.ErrFileNotFound)):
        return S3Error("NoSuchKey")
    if isinstance(e, se.ErrVolumeNotFound):
        # A PUT racing a bucket delete surfaces the missing volume from
        # deep in the write path: a 404 on the bucket, not a 500 (cf.
        # toAPIErrorCode's VolumeNotFound -> NoSuchBucket).
        return S3Error("NoSuchBucket")
    if isinstance(e, (se.ErrErasureReadQuorum, se.ErrErasureWriteQuorum)):
        return S3Error("SlowDown", str(e))
    if isinstance(e, (se.ErrVolumeNotEmpty, se.ErrBucketNotEmpty)):
        return S3Error("BucketNotEmpty")
    if isinstance(e, se.ErrInvalidArgument):
        return S3Error("InvalidArgument", str(e))
    from ..bucket import tier
    if isinstance(e, tier.ErrRestoreInProgress):
        return S3Error("RestoreAlreadyInProgress", str(e))
    if isinstance(e, tier.ErrTierUnavailable):
        # A failing warm backend is retryable: 503, never a 500 (the
        # journal owns the cleanup).
        return S3Error("ServiceUnavailable", str(e))
    return S3Error("InternalError", f"{type(e).__name__}: {e}")
